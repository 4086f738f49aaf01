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
     pairs), K2, K3, K7 and K8 at the whole-molecule shape (B = 1, A = 176:
     Chignolin as one molecule), where the centre passes walk their sources
     in chunks of 48 rows: the same checks (tolerance, bitwise repeats,
     K7/K8 against K2/K3 on K1's stash, device ms, bound and share) and the
     chunked passes' occupancy and grid fill; K5 and K6 (both `last`) at the
     same shape (phase 16(e) takes every kernel to 1,112 slots, where A =
     288 and 752 were checked here before it);
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
     versions (limit 1e-3 eV/A; that run in a thread beside phases 4b and
     5, checked at the end of phase 5); a profiled window of 3 steps gives the
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
     150-step timing run (its steady ms/step from its metrics CSV, beside
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
     `python -m ai2bmd_torch --mode visnet --ckpt-path <that npz>` for 150
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
     (in a thread beside (b)'s work on the card; solvent atoms within 1e-3
     eV/A, protein atoms within the float32
     spread of the subtractive combiner, 2e-2), launches of one evaluation,
     each part's device ms alone (QM, cell assignment, pairs, PME with the
     bonded terms, the protein MM), 5 graphed replays against eager steps,
     20 replays timed, a profiled window, peak memory; again with
     rigid_water=True (SETTLE's constraint violation after the steps); the
     flexible box's Simulator.run through each trajectory writer (phase
     18(c), printed there); (c)
     the CLI on the box with and without --no-write-solvent (frames of
     17,882 and 175 atoms, steady ms/step, the native writer's log line); (d) a model of 4 heads of 64
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
     list build, the full box's MM, the protein's MM) and a trace of the
     full box's MM (kernels, the top 8 by device time; for (c) under
     --polarizable-only alone), 5 replays against eager steps, 10 replays
     timed, no overflow, peak memory; (d) the CLI on the box with
     --polarizable-mm, 3 steps, and side by side with it --mm-method amoeba
     --no-write-xyz on phase 12's ala2 box (251 atoms), 1 step: the CLI's
     AMOEBA dispatch and a DCD alone through the native writer; in the
     whole script they start before (c)'s float32 / float64 checks, and
     (c) waits for them before its timed replays (--polarizable-only runs
     them after (c), --mm-method amoeba on the box, 3 steps, first)
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
     examples/chig.pdb (exit 0, the pair written, 2 solvated steps),
     started after (a), beside (b) and (c), and waited for before (d).  No
     kernel launches in this phase (no ViSNet on its path)
  13. the mesh (ai2bmd_torch.parallel), Chignolin at 9 x 256 with phase 4's
     weights, in worlds of ranks spawned by parallel.launch (each imports
     this script as a module and runs mesh_rank): (a) an NCCL world of one
     rank, mesh 1 x 1; (b) a gloo world of two ranks sharing the card,
     meshes 1 x 2 and 2 x 1 (its times are two processes sharing one card,
     not a multi-card time); (c) with two or more cards, NCCL over
     min(count, 4) of them at 1 x n and n x 1 and the CLI's --replicas 2n
     (with one card it prints that (c) did not run).  On each mesh:
     ShardedPotential's cold (E, F) against the lone FragmentPotential's
     (MESH_TOL), the launches of K1-K4 in a cold and a warm evaluation on
     every rank equal to the lone path's, the ms of a warm evaluation;
     EnsembleSimulation of MESH_REPLICAS replicas, MESH_STEPS steps: its
     initial forces, each replica against its lone replay on its own
     generator (MESH_DX), the launches of the steps, ms per replica-step,
     the ranks of each mp row bitwise equal; ReplicaEnsemble over the
     mesh's dp against the one-card ensemble; every rank reports that it
     imported neither jax nor ai2bmd_tpu and ran no plain edge core
  14. the products' modes (AI2BMD_KERNEL_MM_PRECISION: b3, the production
     3xTF32 split; highest, float32 FMA chains; default, one pass on
     bfloat16-rounded operands; one kernel library each, the other two
     built in a background process at the lowest CPU priority from phase 4
     on, which phase 14 waits for, naming the phases it ran beside;
     `--precision-only` builds them when it starts): (a) the lone helper (tf32x3_mm) in each mode
     against its mode's plain model (ops/tf32x3.py plain_mm) and its error
     against float64 beside cuBLAS float32's (highest within 2x), then K1
     (four flag pairs), K2, K3, K7, K8, K5 and K6 (both `last`) in each mode
     at the four lone batches, the three whole molecules and heads of 8, 16
     and 64 channels: against the mode's plain model (EDGE_TOL; in default
     the outputs of a chain of products within 2^-8 of the scale and
     BF16_SHARE of the bfloat16 rounding's own difference, and the highest
     library, as a control, must miss that for every kernel), bitwise
     repeats, ms a call by CUDA events beside the mode's bound (FMA at 67
     TFLOP/s, one TF32 pass at 495); (b) (`--precision-only`; the default
     run gives its time to phase 19) the lone graphed step at 9 x
     256 in each mode: step 0 and the fixed-cap rows against the CPU float64
     run (b3 and highest within FORCE_LIMIT, default printed beside it),
     ms/step over TIMED_STEPS replays, kernels per step; (c) `python -m
     ai2bmd_torch --matmul-precision` float32, tensorfloat32, bfloat16: the
     precision line each prints, forces against float32's; cuBLAS under
     torch's "highest", "high", "medium" against float64; (d) in (a) and (b)
     every launch came from the asked mode's library
     (ops/_build.py LIBRARY_LAUNCHES); (a) also takes the wide case (H =
     512, 4 heads, 4 x 40: K1 with the update and the stash, K2, K3, K7,
     K8, K5 and K6 in highest and default)
  15. every head and hidden width through the edge kernels: (a) K1 (four
     flag pairs), K2, K3, K7 and K8's wide instantiations at (H, heads) =
     (256, 2), (256, 1), (384, 8), (512, 4), (512, 16), (48, 2), (40, 5)
     at B x A = 4 x 40 and 1 x 176 and (1024, 8) at 4 x 40, against their
     plain versions (EDGE_TOL), bitwise repeats, K7/K8 against K2/K3 on
     K1's stash (bitwise); at 4 x 40 the ms of each kernel beside its plain
     version, bound and share at H = 512 with 4 heads and, timed in the
     same way, the narrow instantiations at H = 256 with 8 heads; the wide
     instantiations' shared memory, blocks per SM, registers, spills and
     source-chunk rows; (b) Chignolin at 3 x 512 with 4 heads of 128
     channels (random weights, seed 0; phase 19 runs 9 x 1,280) through
     the wide K1-K3 as phase 4: one warm
     evaluation's launches K1 12, K2 12, K3 8, K4 1 (phase 4's per batch
     and layer), step 0 against the CPU float64 run (1e-3 eV/A), the
     graphed step (replays against eager steps, ms/step, kernels per step,
     a trace naming the wide kernels); (c) the same weights with remat=True,
     one evaluation through K1 without its stash and K7/K8 against (b)'s
     step 0; (d) save_converted of those weights and `python -m ai2bmd_torch
     --ckpt-path` on them (exit 0, its model line naming K1-K3); (f) 2 x 48
     with 2 heads (H % 32 != 0), its edge weights padded once, against the
     CPU float64 run
  16. the full-layer kernels at every width, and one molecule past 1,024
     slots: (a) K5 and K6 (both `last`) at phase 15(a)'s cases, on the
     weights the model hands them (padded once at H % 32 != 0): against
     their plain versions (EDGE_TOL), bitwise repeats, K6's recomputed a_ij
     equal to K5's (their s_e scratch bitwise); at 4 x 40 the ms beside
     the plain version, bound and share at H = 512 with 4 heads and at the
     narrow H = 256 with 8 heads; every wide stage's shared memory, blocks
     per SM, registers and spills; (b) phase 15(b)'s model with
     AI2BMD_FUSED_LAYER=1 driven as phase 4b: one warm evaluation launches
     K5 12 and K6 12 and none of K1-K3, step 0 against the CPU float64 run
     (phase 15(b)'s) beside 15(b)'s, the graphed step; (c) the CLI on its
     .npz with AI2BMD_FUSED_LAYER=1, its model line naming K5/K6's wide
     instantiations; (d) 15(f)'s 2 x 48 with 2 heads through K5/K6 against
     float64, its layer weights padded once; (e) ACE-(ALA)110-NME
     (build_polyalanine, alpha helix), 1,112 slots as one molecule: K1 (four
     flag pairs), K2, K3, K7, K8, K5 and K6 at 1 x 1,112 on its graph at H
     = 256 (8 heads) and 512 (4 heads) against their plain versions where
     those fit in memory, bitwise repeats; ViSNetPotential at 9 x 256 with
     remat=True and through K5/K6, one evaluation each (launches, CUDA-event
     ms, peak memory), the two within 1e-3 eV/A
  17. the mixed-precision mode (ViSNetConfig(edge_dtype=torch.bfloat16)):
     (a) the bfloat16 instantiations of K1 (four flag pairs), K2, K3, K7 and
     K8 against their plain bfloat16 versions (2^-7 of the largest value),
     narrow at the lone batches and 1 x 176 (H = 256, 8 heads), wide at 4 x
     40 with H = 512 (4 heads) and H = 48 (2 heads), bitwise repeats, K7/K8
     against K2/K3 on the bfloat16 stash (printed, not bitwise in this
     mode), at the lone batches each kernel's ms beside the float32
     kernel's and the plain version's, bytes, bound and share; (b) every
     bfloat16 kernel at 4 x 40, narrow and wide, from the highest and
     default libraries against its mode's plain model; (c) the lone
     Chignolin step at 9 x 256 in the mode: one evaluation launches the
     bfloat16 K1 36, K2 36, K3 32 and K4 1 and nothing else, step 0 against
     the CPU float64 run of the float32 model (the mode's shift) and against
     the mixed step on the CPU through the plain versions (within half the
     shift; that run in a thread beside the graphed step), the graphed step
     (its trace's edge kernels all bfloat16)
     beside phase 4's; (d)
     Chignolin (176 slots) and ACE-(ALA)110-NME (1,112) as one molecule,
     one evaluation each in float32 with remat and in the mode with and
     without remat (launches, ms, peak memory), the mode's forces within
     (c)'s shift of float32's; (e) the float32 edge and full-layer kernels'
     output hashes equal adb0db2's
  18. the native trajectory writer (ai2bmd_torch.runtime): (a) its g++
     build at this process's first use (path, seconds, cached);
     (b) RUNTIME_FRAMES frames of the solvated box (17,882 atoms, each moved
     from chig-preeq.pdb by a seeded jitter, its cell) through the native
     writer and through the Python writers: ms a frame (native: the submit),
     pending() after the submits, the native close's drain; the XYZ bytes
     equal, the DCDs equal apart from the title record, read_dcd giving the
     frames and cells back exactly; (c) phase 9c's CLI lines (the native
     writer), and phase 9b's flexible-water Simulator run for WRITER_STEPS
     steps recording every RECORD, through the native writer and through the
     Python writers (this script makes the runtime unavailable for that
     run): the metrics CSV's ms/step of each, from one call
  19. past 1,024 channels: (a) K1 (four flag pairs), K2, K3, K7, K8, K5
     and K6 (both `last`) at (H, heads) = (1,064, 8) (heads of 133: the
     padded route), (1,280, 8), (2,048, 16) and (4,096, 16), B x A = 2 x 24
     and 1 x 176 (4,096 at 2 x 24 alone; --past-1024-only adds (8,192, 32)
     at 2 x 24), against their plain versions
     within EDGE_TOL, bitwise repeats, K7/K8 against K2/K3 on K1's stash,
     K6's a_ij against K5's; the bfloat16 storage at (1,280, 8) and (2,048,
     16) and the highest / default libraries at (1,280, 8), 2 x 24; (b)
     each wide kernel's shared memory, blocks an SM, registers, spill,
     chunk rows and k-tile width at H = 1,280, 2,048, 4,096 and 8,192 (the
     launchers' own sizes; none past 227 KB); (c) at (1,280, 8), 4 x 40,
     each kernel's device ms beside its plain version's, bound and share;
     (d) Chignolin at 9 x 1,280 with 8 heads (random, seed 0) through K1-K3
     and K4, then through K5/K6 (AI2BMD_FUSED_LAYER=1), each driven as
     phase 4 (graphed ms/step, kernels a step, busy share, the capture's
     peak memory; an evaluation's launches equal to phase 4's per batch),
     one evaluation with remat against step 0, step 0 through each path
     against the other, and a 3 x 1,280 model of the same seed through each
     path against the CPU float64 run (FORCE_LIMIT); (e) the CLI on those
     weights (save_converted), 10 steps recording every 5
  20. one JSON line of kernel results (with `mesh_launches`: rank 0's
     launches a warm evaluation in (b), by mesh; `precision_modes`: phase
     14's figures by mode; `wide`: phases 15's and 16's; `slots_1112`:
     phase 16(e)'s; the `_bf16` entries: phase 17's; `past_1024`: phase
     19's), the card's name and power limit, and the final JSON line.

`--stop-after 2|3` ends after that phase, without the final line (for a
first check of a kernel change); `--solvated-only` runs phases 9 and 10
alone after the build, without it; `--polarizable-only` phase 11 alone;
`--amoeba-only` phase 12 alone; `--mesh-only` phase 13 alone; `--precision-only` phase 14
alone; `--wide-only` phase 15 alone; `--layer-wide-only` phase 16 alone;
`--mixed-only` phase 17 alone; `--runtime-only` phase 18 alone (its (c)
builds the box again and leaves out phase 9c's CLI lines);
`--past-1024-only` phase 19 alone;
`--preprocess-full` runs only
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
# Chignolin as one molecule, padded to 8 (four source chunks); the longer
# molecules' kernel checks are phase 16(e)'s, at 1,112 slots (24 chunks)
WHOLE_SHAPES = [(1, 176)]
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
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): float32
# outside the tensor cores; TF32 in the tensor cores over the three passes of
# the 3xTF32 split, in float32 products; bfloat16 x bfloat16 in the tensor
# cores with float32 sums; HBM3.
PEAK_F32, PEAK_TF32X3, PEAK_BF16, PEAK_BYTES = 67e12, 495e12 / 3, 989e12, 3.35e12
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


def in_thread(fn):
    """Start fn() in a thread of its own, beside the card's work; fn makes no
    CUDA call (a capture on the card would take it for one of its own).
    Returns a function that waits for it and returns (fn's result, seconds
    waited), or raises fn's error."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:   # raised again by the waiter
            box["err"] = e

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        t0 = time.perf_counter()
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["out"], time.perf_counter() - t0

    return wait


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


def bound(nbyte, tc=0.0, f32=0.0, bf16=0.0):
    """The least time the card could take: the largest of the tensor-core
    time (FLOPs with a float32 operand at the 3xTF32 peak, plus FLOPs of two
    bfloat16 operands at the bfloat16 peak: one unit), the float32 FMA FLOPs
    over theirs (the two units can run at once) and bytes (each input read
    once, each output written once) over the memory rate."""
    t_op = max(tc / PEAK_TF32X3 + bf16 / PEAK_BF16, f32 / PEAK_F32) * 1e3
    t_by = nbyte / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_op, t_by), "bound_by": "operations" if t_op >= t_by else "bytes",
            "gflop": (tc + f32 + bf16) / 1e9, "mbytes": nbyte / 1e6}


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


def edge_inputs(torch, gen, B, A, dev, H=H, pos=None):
    """Random edge-core inputs at (B, A) and width H, drawn on ``gen``'s
    device; the graph from random positions, or from ``pos`` [B, A, 3] (on
    the CPU)."""
    from ai2bmd_torch.models.visnet import spherical_harmonics

    r = lambda *s, sc=0.3: (torch.randn(s, generator=gen, device=gen.device) * sc).to(dev)
    pos = torch.randn((B, A, 3), generator=gen) * 2.5 if pos is None else pos
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


def edge_case(torch, K, gen, B, A, dev, H=H, NH=NH, pos=None):
    """Inputs at (B, A) and width H with NH heads, K1's stash of them, random
    cotangents, and a random message-path g_edge for K3/K8 to sum into: the
    arguments of K2, K3, K7 and K8 (the graph from ``pos`` when given)."""
    a = edge_inputs(torch, gen, B, A, dev, H, pos)
    core = (a["q"], a["k"], a["v"], a["vec"], a["edge"], a["d_sh"], a["dist"], a["adj"],
            a["w_dkv"], a["b_dkv"], a["w_s"], a["b_s"], CUTOFF, NH)
    upd = dict(wt=a["wt"], wsrc=a["wsrc"], w_f=a["w_f"], b_f=a["b_f"])
    _, _, _, zdkv, zs, zf = K.edge_fwd(*core, **upd, store=True)
    rand = lambda *s: torch.randn(s, generator=gen, device=gen.device)
    adj = a["adj"].to(gen.device)[..., None]
    g_x = rand(B, A, H).to(dev)
    g_va = rand(B, A, S, H).to(dev)
    g_df = (rand(B, A, A, H) * adj).to(dev)
    g_edge = (rand(B, A, A, H) * adj).to(dev)
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


def layer_inputs(torch, gen, B, A, dev, H=H, pos=None):
    """A fused layer's inputs at shape (B, A) and width H: a graph from
    random positions (the last fragment's last 3 slots masked) or from
    ``pos`` (every slot valid), random streams, and cotangents.
    Sphere-major vec and d_sh."""
    from ai2bmd_torch.models.visnet import ViSNetConfig, dense_graph

    mask = torch.ones((B, A), dtype=torch.bool)
    if pos is None:
        pos = torch.randn((B, A, 3), generator=gen) * 2.5
        mask[-1, A - 3:] = False
    adj, _, dist, d_sh = dense_graph(pos, mask, ViSNetConfig())
    adj = adj.float().to(gen.device)
    r = lambda *s, sc: torch.randn(s, generator=gen, device=gen.device) * sc
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


def drive(torch, dev, prot, pot, card, path_kernels, warm=WARM_STEPS, timed=TIMED_STEPS):
    """Cold caps, step 0, ``warm`` + ``timed`` warm Langevin steps, with the
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
    for _ in range(warm):
        state = step(state)
        energies.append(state.energy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state = step(state)
        energies.append(state.energy)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / timed
    launches = dict(LAUNCHES)
    energies = torch.stack(energies)
    print(f"  steps: {state.step} warm Langevin steps after step 0; launches {launches}")
    print(f"  energies (eV): first {float(energies[0]):.6f}  last {float(energies[-1]):.6f}")
    need(bool(energies.isfinite().all()), "non-finite energy in the run")
    need(bool(state.positions.isfinite().all() and state.forces.isfinite().all()),
         "non-finite positions or forces in the run")
    need(state.step >= warm + timed, f"fewer than {warm + timed} warm steps")
    print(f"  steady state: {ms_step:.3f} ms/step over {timed} steps "
          f"(smoke figure, not a benchmark; host clock, synchronised; {card})")
    eager = profile_steps(torch, step, state)
    graphed = drive_graphed(torch, pot.stateful_energy_forces, coeffs, masses, state, gen, card,
                            ("cap_grad_kernel", *path_kernels), timed)
    print(f"  eager / graphed: {ms_step:.3f} / {graphed['ms_step']:.3f} ms/step, "
          f"{eager['kernels_per_step']:.0f} / {graphed['kernels_per_step']:.0f} kernels per "
          f"step, {100 * eager['busy_share']:.1f}% / {100 * graphed['busy_share']:.1f}% busy")
    return launches, ms_step, P, aux0, aux1, e0, f0, graphed


def drive_graphed(torch, potential, coeffs, masses, state, gen, card, trace_kernels,
                  timed=TIMED_STEPS):
    """The step of ``potential`` (the stateful protocol) captured as one CUDA
    graph (GraphedLangevin) from ``state``: peak memory of the capture; the
    first GRAPH_CHECK_STEPS replays held against eager langevin_step calls
    from the same state on the same noise (max|dx|, max|dF|, limit
    FORCE_LIMIT: the force stitch sums with atomics, so not bitwise);
    ``timed`` replays timed by the host clock and by CUDA events; a
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
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    print(f"  graph: {time.perf_counter() - t0:.1f} s (warm-up "
          f"{graphed.setup_seconds['warmup']:.1f} s, capture {graphed.setup_seconds['capture']:.1f}"
          f" s); peak device memory above the {base / 2**20:.1f} MiB held before: "
          f"{peak_mib:.1f} MiB")
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
    for _ in range(timed):
        energies.append(graphed.run(1).energy.clone())
    end.record()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / timed
    ms_events = start.elapsed_time(end) / timed
    s = graphed.state
    need(bool(torch.stack(energies).isfinite().all()), "non-finite energy in the graphed run")
    need(bool(s.positions.isfinite().all() and s.forces.isfinite().all()),
         "non-finite positions or forces in the graphed run")
    print(f"  graphed: {ms_step:.3f} ms/step (host clock, synchronised), {ms_events:.3f} (CUDA "
          f"events) over {timed} replays after step {s.step - timed} (smoke "
          f"figure; {card})")
    prof = profile_steps(torch, lambda _: graphed.run(1), None, label="replayed steps")
    for name in trace_kernels:
        need(any(name in n for n in prof["names"]), f"the replay trace names no {name}")
    print(f"  the replay trace names {', '.join(trace_kernels)}")
    return dict(ms_step=ms_step, ms_events=ms_events, peak_mib=peak_mib, **prof)


def run_slice(torch, dev, prot, card):
    """Phase 4: the slice through K1-K3; returns its launches, ms/step, the
    card's step 0 and its CPU float64 reference, started in a thread
    (finish_slice holds phases 4 and 4b to it)."""
    pot, cfg, params = build_potential(torch, dev, prot, fused=False)
    launches, ms_step, P, aux0, aux1, e0, f0, graphed = drive(torch, dev, prot, pot, card,
                                                              EDGE_KERNELS)
    for name in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "cap_grad"):
        need(launches[name] > 0, f"kernel {name} was not launched on the main path")
    for name in ("vislayer_fwd", "vislayer_bwd", "edge_bwd_msg_rc", "edge_bwd_upd_rc",
                 "tf32x3_mm"):
        need(launches[name] == 0, f"{name} ran on the edge-core path")
    wait = start_slice_reference(torch, prot, cfg, params, pot, P, aux0, aux1)
    return (launches, ms_step, graphed, dict(aux0=aux0, e0=e0, f0=f0),
            (wait, pot, cfg, P))


def finish_slice(torch, ref, pending, step0_fl):
    """Phases 4 and 4b, step 0 against the CPU float64 run that ran beside
    phases 4b and 5: phase 4's forces and its fixed-cap rows', and phase
    4b's (``step0_fl``: its E, F); adds the reference to ``ref``."""
    wait, pot, cfg, P = pending
    ref.update(finish_slice_reference(wait, "beside phases 4b and 5"))
    print("  phase 4's step 0:")
    dF, dF_fix = step0_errors(torch, pot, cfg, P, ref["e0"], ref["f0"], ref)
    need(dF <= FORCE_LIMIT, f"step-0 forces differ from the float64 reference by {dF:.3e}")
    need(dF_fix <= FORCE_LIMIT, f"fixed-cap forces differ by {dF_fix:.3e}")
    e0, f0 = step0_fl
    dF_ref = float((f0.to(torch.device("cpu"), torch.float64) - ref["f_ref"]).abs().max())
    print(f"  phase 4b's step 0 (K5/K6) vs CPU float64 plain |dE| "
          f"{abs(float(e0) - float(ref['e_ref'])):.3e} eV, max|dF| {dF_ref:.3e} eV/A "
          f"(limit {FORCE_LIMIT})")
    need(dF_ref <= FORCE_LIMIT, f"4b: step-0 forces differ from the float64 reference by "
         f"{dF_ref:.3e}")


def start_slice_reference(torch, prot, cfg, params, pot, P, aux0, aux1):
    """Step 0 of the slice on the CPU in float64 through the plain versions,
    from the card's cold-cap offsets ``aux0``, and the ViSNet forces at the
    rows the card's step 0 used (warm caps ``aux1``: fixed caps, the measure
    of the JAX package's benchmarks/kernel_precision.py): built and copied
    to the host here, evaluated in a thread (in_thread).  Returns its
    waiter for finish_slice_reference."""
    from ai2bmd_torch.frag import runtime as RT
    from ai2bmd_torch.models.visnet import ViSNet
    from ai2bmd_torch.potentials import FragmentPotential

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    pot64 = FragmentPotential.build(prot, ViSNet(cfg, params).to(torch.float64), cfg,
                                    longrange="mm", device="cpu")
    pos_card = RT.build_row_positions(pot.rt, P) + aux1
    P64, aux64, pos64 = (t.to(cpu, torch.float64) for t in (P, aux0, pos_card))

    def reference():
        e_ref, f_ref, _ = pot64.stateful_energy_forces(P64, aux64)
        _, f_fix_ref = RT._fragment_terms(pot64.module.params(), pot64.rt, pos64, cfg)
        return dict(e_ref=e_ref, f_ref=f_ref, aux1=aux1, pos_card=pos_card,
                    f_fix_ref=f_fix_ref, seconds=time.perf_counter() - t0)

    return in_thread(reference)


def finish_slice_reference(wait, beside):
    """The reference of start_slice_reference, its seconds printed."""
    ref, waited = wait()
    print(f"  CPU float64 reference of step 0 and of the fixed-cap rows: "
          f"{ref.pop('seconds'):.1f} s ({beside}; waited {waited:.1f} s for it)")
    return ref


def slice_reference(torch, prot, cfg, params, pot, P, aux0, aux1):
    """start_slice_reference, waited for at once."""
    return finish_slice_reference(
        start_slice_reference(torch, prot, cfg, params, pot, P, aux0, aux1), "alone")


def step0_errors(torch, pot, cfg, P, e0, f0, ref):
    """Step 0's max|dF| against the CPU float64 run, and the ViSNet forces'
    at the fixed-cap rows of ``ref``, through ``pot``'s kernels."""
    from ai2bmd_torch.frag import runtime as RT

    cpu = torch.device("cpu")
    dF = float((f0.to(cpu, torch.float64) - ref["f_ref"]).abs().max())
    dE = abs(float(e0) - float(ref["e_ref"]))
    _, f_fix = RT._fragment_terms(pot.module.params(), pot.rt, ref["pos_card"], cfg)
    dF_fix = float((f_fix.to(cpu, torch.float64) - ref["f_fix_ref"]).abs().max())
    print(f"  step 0 vs CPU float64 plain: |dE| {dE:.3e} eV, max|dF| {dF:.3e} eV/A "
          f"(limit {FORCE_LIMIT}); fixed caps max|dF| {dF_fix:.3e} eV/A; "
          f"max|F| {float(ref['f_ref'].abs().max()):.3f} eV/A")
    return dF, dF_fix


def run_fused_slice(torch, dev, prot, card, ref):
    """Phase 4b: the slice through K5/K6, held against phase 4's step 0 on
    the card (finish_slice holds it to the CPU float64 run); returns its
    launches, ms/step, graphed figures and step 0 (E, F)."""
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
    dF_card = float((f0.to(cpu, torch.float64) - ref["f0"].to(cpu, torch.float64)).abs().max())
    print(f"  step 0 (cold-cap offsets bitwise equal to phase 4's: {same_caps}): "
          f"vs K1-K3 on the card |dE| {abs(float(e0) - float(ref['e0'])):.3e} eV, "
          f"max|dF| {dF_card:.3e} eV/A (limit {FORCE_LIMIT}; against the CPU float64 run at "
          f"the end of phase 5)")
    need(same_caps, "the full-layer run started from other cap offsets than phase 4")
    need(dF_card <= FORCE_LIMIT, f"step-0 forces differ from the K1-K3 path by {dF_card:.3e}")
    return launches, ms_step, graphed, (e0, f0)


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
TIMING_DT_FS = 0.01           # the CLI timing run (CLI_STEPS steps)
PREEQ_STEPS, RECORD, PROD_STEPS = 4, 10, 40
CLI_STEPS, CLI_RECORD = 150, 50
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


def _cli_start(cmd, fused_layer=False, cards=None):
    """Start a CLI subprocess; ``fused_layer`` sets AI2BMD_FUSED_LAYER=1 in its
    environment, as a user selects the full-layer kernels; ``cards`` n shows
    it only the first n of this process's cards (CUDA_VISIBLE_DEVICES)."""
    env = {k: v for k, v in os.environ.items() if k != "AI2BMD_FUSED_LAYER"}
    if fused_layer:
        env["AI2BMD_FUSED_LAYER"] = "1"
    if cards is not None:
        import torch

        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        ids = visible.split(",") if visible else [str(i) for i in range(torch.cuda.device_count())]
        env["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:cards])
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
    # the CPU float64 reference in a thread, beside (b)'s graph, (c) and (d)
    # (the card does their work; their host-clock figures share the host)
    P64 = P.to("cpu", torch.float64)

    def float64_reference():
        t0 = time.perf_counter()
        pot64 = ViSNetPotential.build(prot.numbers, ViSNet(cfg2, params2).to(torch.float64),
                                      cfg2, device="cpu")
        return pot64.energy_forces(P64), time.perf_counter() - t0

    wait_reference = in_thread(float64_reference)
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
    del pot, state

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
    ((e_ref, f_ref), secs), waited = wait_reference()
    dF = float((f0.to("cpu", torch.float64) - f_ref).abs().max())
    print(f"  (b) step 0 vs CPU float64 plain: |dE| {abs(float(e0) - float(e_ref)):.3e} eV, "
          f"max|dF| {dF:.3e} eV/A (limit {FORCE_LIMIT}); max|F| {float(f_ref.abs().max()):.3f} "
          f"eV/A; the reference took {secs:.1f} s beside (b)-(d), waited {waited:.1f} s for it")
    need(dF <= FORCE_LIMIT, f"whole-molecule step-0 forces differ from float64 by {dF:.3e}")
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


def solvated_reference(torch, ps, P, cfg, params, threaded=False, **qmmm_kw):
    """The port on the CPU in float64 at the card's state: QMMMPotential of
    the whole box (plain versions; ``qmmm_kw`` for its build), the QM side
    from the card's cold cap offsets with one warm iteration.  Returns (E, F,
    seconds); with ``threaded``, built here and evaluated in a thread
    (in_thread), whose waiter it returns."""
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

    def run():
        e, f, _ = qmmm64(P64, qmmm64.init_aux(P64))
        return e, f, time.perf_counter() - t0

    return in_thread(run) if threaded else run()


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
        # the CPU float64 run of step 0, in a thread beside (b)'s work on the card
        wait_ref = solvated_reference(torch, ps, state.positions, cfg, params, threaded=True)
        out.update(forces0=state.forces.cpu())
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
    else:
        (e_ref, f_ref, secs), waited = wait_ref()
        dF = (out["forces0"].double() - f_ref).abs().max(-1).values
        dF_solv, dF_prot = float(dF[solvent].max()), float(dF[~solvent].max())
        dE = abs(float(state.energy) - float(e_ref))
        print(f"  (b) step 0 vs the port on the CPU in float64 ({secs:.1f} s beside (b)'s work "
              f"on the card, waited {waited:.1f} s for it): solvent atoms max|dF| {dF_solv:.3e} "
              f"eV/A (limit {FORCE_LIMIT}); protein atoms max|dF| {dF_prot:.3e} eV/A (limit "
              f"{PROTEIN_SPREAD}, the float32 spread of the subtractive combiner; the JAX "
              f"package's own float32 figure on this box {JAX_PROTEIN_F32}); |dE| {dE:.3e} eV "
              f"of |E| {abs(float(e_ref)):.1f}; max|F| {float(f_ref.abs().max()):.2f} eV/A")
        need(dF_solv <= FORCE_LIMIT, f"solvent forces differ from float64 by {dF_solv:.3e}")
        need(dF_prot <= PROTEIN_SPREAD, f"protein forces differ from float64 by {dF_prot:.3e}")
        out.update(dF_solvent=dF_solv, dF_protein=dF_prot, dE=dE)
        # phase 18(c)'s library half, printed there
        out["writers"] = writer_runs(torch, sim, sim.advance(final, 1), root)
    return out


def run_solvated_cli(torch, root):
    """Phase 9c: `python -m ai2bmd_torch` on the solvated box, with and
    without --no-write-solvent, one after the other (side by side they
    would share the card): exit 0, the DCD's atoms, the steady ms/step of
    the metrics CSV, the native writer's log line (printed in phase 18)."""
    from ai2bmd_torch.io.trajectory import read_dcd

    runs = {"solvent": [], "no-write-solvent": ["--no-write-solvent"]}
    t0 = time.perf_counter()
    outs = {name: _cli_wait(name, _cli_start([
        sys.executable, "-m", "ai2bmd_torch", "--prot-file", SOLVATED, "--log-dir",
        os.path.join(root, f"cli_{name}"), "--preeq-steps", "0", "--sim-steps",
        str(SOLV_CLI_STEPS), "--record-per-steps", str(SOLV_CLI_RECORD), "--timestep",
        str(SOLV_DT_FS), *extra])) for name, extra in runs.items()}
    wall = time.perf_counter() - t0
    steady, writer = {}, {}
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
        traj = [ln for ln in outs[name].splitlines() if ln.startswith("trajectory:")]
        need(traj == ["trajectory: native writer (XYZ, DCD)"], f"CLI {name}: writer lines {traj}")
        writer[name] = traj[0]
        print(f"  (c) --prot-file {SOLVATED} {' '.join(runs[name])}: exit 0, "
              f"{frames.shape[0]} frames of {want} atoms; {qm_line[0]!r}; metrics ms/step "
              f"{[r['ms_per_step'] for r in rows]}")
    print(f"  (c) the two runs took {wall:.1f} s")
    return steady, writer


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
    cli, cli_writer = run_solvated_cli(torch, root)
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
                cli=cli, cli_writer=cli_writer, plain_edge_core=plain)


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


def run_polarizable_route(torch, dev, card, root, name, kw, flex, breakdown=True,
                          before_timed=None):
    """Phase 11 (a)-(c), one route of the solvated box through
    ProteinSimulation.from_pdb(**kw) at 9 x 256: build, step 0 (against
    phase 9b's cellpair forces for ``nl``, against the port on the CPU in
    float64 but for AMOEBA, and only when phase 9b's forces are not at
    hand: the whole script leaves the two CPU references out for phase
    16's time), the launches of one evaluation, with ``breakdown`` each part
    captured alone (QM, the list build, the full box's MM, the protein's MM)
    and the full box's MM traced, POL_STEPS graphed replays against eager
    steps, then (``before_timed()`` first, when given: the card to itself)
    POL_TIMED replays timed, no overflow, peak memory."""
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
    if qmmm.amoeba is None and "forces0" in flex:
        print(f"  ({name}) the CPU float64 reference is left out in the whole script (run "
              f"--polarizable-only for it)")
    elif qmmm.amoeba is None:
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
    if breakdown:
        out["parts_ms"] = {k: graph_ms(torch, fn) for k, fn in parts.items()}
        print(f"  ({name}) one evaluation launches {out['launches']}; each part captured alone, "
              f"ms a replay (events): "
              + ", ".join(f"{k} {v:.3f}" for k, v in out["parts_ms"].items()))
        trace = _trace(torch, parts["MM full box"], 1)
        top = sorted(trace.items(), key=lambda kv: -kv[1][1])[:POL_TOP]
        out["mm_kernels"] = sum(c for c, _ in trace.values())
        out["mm_top"] = [(short_name(n), c, us / 1e3) for n, (c, us) in top]
        print(f"  ({name}) the full box's MM, one eager call traced: {out['mm_kernels']} "
              f"kernels, {sum(us for _, us in trace.values()) / 1e3:.1f} device ms; the top "
              f"{POL_TOP} (name x launches: ms): "
              + "; ".join(f"{n} x{c}: {ms:.1f}" for n, c, ms in out["mm_top"]))
    else:
        print(f"  ({name}) one evaluation launches {out['launches']}; its parts captured alone "
              f"and its MM traced are left out in the whole script (run --polarizable-only "
              f"for them)")
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
    if before_timed is not None:
        before_timed()
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


def start_polarizable_cli(torch, root, amoeba: bool):
    """Phase 11(d): `python -m ai2bmd_torch` with --polarizable-mm on the
    solvated box, POL_CLI_STEPS steps, and side by side with it --mm-method
    amoeba --no-write-xyz on phase 12's ala2 box (251 atoms), one step: the
    CLI's AMOEBA dispatch, and a DCD alone through the native writer; with
    ``amoeba`` (--polarizable-only), --mm-method amoeba on the solvated box
    first, POL_CLI_STEPS steps.  Each: exit 0, the QM/MM line naming the
    route and the engine, the writer line, the trajectory files.  Starts
    the first runs and returns a function that waits for them, runs the
    rest, checks each and returns {run: metrics ms/step}."""
    from ai2bmd_torch.io import build as B
    from ai2bmd_torch.io.pdb import write_pdb
    from ai2bmd_torch.preprocess import solvate

    small = os.path.join(root, "ala2-box.pdb")
    small_atoms = solvate(B.build_polyalanine(2), padding=4.0, seed=0)
    write_pdb(small, small_atoms)
    # name: (input, atoms, steps, flags, MM engine, files written)
    runs = {"amoeba": (SOLVATED, 17882, POL_CLI_STEPS, ["--mm-method", "amoeba"], "AMOEBA",
                       "XYZ, DCD"),
            "polarizable": (SOLVATED, 17882, POL_CLI_STEPS, ["--polarizable-mm"],
                            "ff19SB + induced dipoles", "XYZ, DCD"),
            "amoeba_small": (small, len(small_atoms), 1, ["--mm-method", "amoeba",
                                                          "--no-write-xyz"], "AMOEBA", "DCD")}

    def start(name):
        pdb, _, steps, extra, _, _ = runs[name]
        return _cli_start([
            sys.executable, "-m", "ai2bmd_torch", "--prot-file", pdb, "--log-dir",
            os.path.join(root, f"cli_pol_{name}"), "--preeq-steps", "0", "--sim-steps",
            str(steps), "--record-per-steps", "1", "--timestep", str(SOLV_DT_FS), *extra])

    waves = [["amoeba"]] if amoeba else []
    waves.append(["polarizable", "amoeba_small"])      # side by side
    t_first = time.perf_counter()
    first = {name: start(name) for name in waves[0]}
    return lambda: finish_polarizable_cli(torch, root, runs, waves, start, first, t_first)


def finish_polarizable_cli(torch, root, runs, waves, start, first, t_first):
    """Phase 11(d), started by start_polarizable_cli: waits for each wave of
    runs (``first`` the first wave's, started at ``t_first``) and checks
    each.  Returns {run: metrics ms/step}."""
    from ai2bmd_torch.io.trajectory import read_dcd

    out = {}
    for i, wave in enumerate(waves):
        t0 = t_first if i == 0 else time.perf_counter()
        procs = first if i == 0 else {name: start(name) for name in wave}
        txts = {name: _cli_wait(name, proc) for name, proc in procs.items()}
        wall = time.perf_counter() - t0
        for name, txt in txts.items():
            pdb, n, steps, extra, engine, kinds = runs[name]
            d = os.path.join(root, f"cli_pol_{name}")
            stem = os.path.join(d, os.path.basename(pdb)[:-4] + "-traj")
            frames = read_dcd(stem + ".dcd")
            need(frames.shape == (steps, n, 3) and bool(torch.as_tensor(frames).isfinite().all()),
                 f"CLI {name}: DCD {frames.shape}")
            need(os.path.exists(stem + ".xyz") == ("XYZ" in kinds), f"CLI {name}: the XYZ file")
            line = [ln for ln in txt.splitlines() if ln.startswith("QM/MM:")]
            need(line and f"nl pairs, {engine} MM" in line[0], f"CLI {name}: QM/MM line {line}")
            traj = [ln for ln in txt.splitlines() if ln.startswith("trajectory:")]
            need(traj == [f"trajectory: native writer ({kinds})"],
                 f"CLI {name}: writer lines {traj}")
            rows = _metrics(os.path.join(d, os.path.basename(pdb)[:-4] + "-metrics.csv"))
            out[name] = [r["ms_per_step"] for r in rows]
            print(f"  (d) {os.path.basename(pdb)} {' '.join(extra)}: exit 0, {frames.shape[0]} "
                  f"frames of {n} atoms, {traj[0]!r}; {line[0]!r}; metrics ms/step {out[name]}")
        print(f"  (d) {' and '.join(wave)} took {wall:.1f} s"
              + (" side by side" if len(wave) > 1 else ""))
    return out


def run_polarizable(torch, dev, card, root, flex, amoeba_cli=False):
    """Phase 11: the nl pair route, the induced-dipole hybrid and AMOEBA QM/MM
    on the solvated box at 9 x 256, each one captured step; AMOEBA's MM
    float32 against float64; the CLI's --polarizable-mm (``amoeba_cli``:
    and --mm-method amoeba)."""
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
    whole = "forces0" in flex     # the whole script: (d) beside (c)'s checks, no breakdown
    if whole:
        print("  (d) the CLI's --polarizable-mm and --mm-method amoeba runs start now, beside the "
              "float32 / float64 checks and (c)'s build, capture and eager steps; (c) waits for "
              "them before its timed replays")
        wait_cli = start_polarizable_cli(torch, root, amoeba_cli)
        cli = {}
        before = lambda: cli.update(out=wait_cli())
    syn, _ = synthetic_amoeba_box()
    out["spread_syn"] = amoeba_mm_spread(torch, dev, syn, "the synthetic box",
                                         {k: 2 * v for k, v in AMOEBA_JAX_SPREAD.items()})
    from ai2bmd_torch.host import load_protein

    out["spread_box"] = amoeba_mm_spread(torch, dev, load_protein(SOLVATED).atoms,
                                         "the solvated box",
                                         dict(solvent=FORCE_LIMIT, protein=PROTEIN_SPREAD))
    out["amoeba"] = run_polarizable_route(torch, dev, card, root, "c", dict(mm_backend="amoeba"),
                                          flex, breakdown=not whole,
                                          before_timed=before if whole else None)
    no_plain("11c")
    out["cli"] = cli["out"] if whole else start_polarizable_cli(torch, root, amoeba_cli)()
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
    # (e) the CLI starts now, beside (b) and (c); (d) waits for it before its capture
    t_cli = time.perf_counter()
    d_cli = os.path.join(root, "amoeba_cli")
    shutil.rmtree(d_cli, ignore_errors=True)
    cli = _cli_start([
        sys.executable, "-m", "ai2bmd_torch", "--prot-file", "examples/chig.pdb", "--log-dir",
        d_cli, "--preprocess", "--preprocess-method", "AMOEBA", "--max-cyc", str(AMOEBA_CLI_CYC),
        "--preeq-steps", "0", "--sim-steps", "2", "--record-per-steps", "1", "--timestep",
        str(SOLV_DT_FS)])
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

    txt = _cli_wait("amoeba-preprocess", cli)
    cli_s = time.perf_counter() - t_cli

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

    # (e) the CLI, started after (a)
    lines = [ln for ln in txt.splitlines() if "AMOEBA minimization" in ln or "RMS |F|" in ln]
    need(len(lines) == 2 and f"[{AMOEBA_CLI_CYC}/{AMOEBA_CLI_CYC}]" in lines[1],
         f"the CLI's AMOEBA lines: {lines}")
    need(all(os.path.exists(os.path.join(d_cli, f"chig-preeq{s}.pdb")) for s in ("", "-nowat")),
         "the CLI wrote no -preeq pair")
    need("Simulation finished!" in txt, "the CLI run did not finish")
    print(f"  (e) --preprocess --preprocess-method AMOEBA --max-cyc {AMOEBA_CLI_CYC}: exit 0 in "
          f"{cli_s:.1f} s (beside (b) and (c)), the pair written; {lines[1].strip()!r}")
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"  AMOEBA preprocessing ({res['atoms']} atoms, {AMOEBA_MAX_CYC} cycles): "
          f"{res['wall_s']:.2f} s wall, {res['cycle_ms']:.3f} ms a captured cycle, peak "
          f"{res['peak_gib']:.2f} GiB; AmoebaMD {res['md_ms']:.3f} ms/step; phase 12 took "
          f"{res['phase_s']:.1f} s ({card})")
    return res


# Phase 13: the mesh.  The ranks are spawned (ai2bmd_torch.parallel.launch),
# each importing this script as a module and running mesh_rank.  NCCL does
# not put two ranks on one device, so on one card the two-rank world runs
# gloo: its collectives carry CUDA tensors through the host, and its times
# are two processes sharing one card, not a multi-card time.
MESH_REPLICAS, MESH_STEPS, MESH_SEED = 4, 3, 5
# the sharded (E, F) against the lone path: JAX's own bar, 1e-4 (+ 1e-7 |E|
# for the energy's float32 sums taken in another order), tests/test_parallel.py:58-81
MESH_TOL = 1e-4
# a replica after MESH_STEPS steps against its lone replay: only the order
# of the sums (the stitch's atomics, the all-reduce) parts them
MESH_DX = 1e-5              # A
MESH_KERNELS = ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "cap_grad")
# the most a world of phase 13 may take before it is failed (s)
MESH_WORLD_S = 300


def mesh_rank(rank, meshes):
    """Phase 13 on one rank of a world: for each (n_dp, n_mp) mesh,
    ShardedPotential at Chignolin 9 x 256 (phase 4's weights) cold and warm
    with the launches of each evaluation and the ms of a warm one;
    EnsembleSimulation of MESH_REPLICAS replicas for MESH_STEPS steps (the
    launches, ms per replica-step, every replica gathered and this rank's
    own); ReplicaEnsemble over the mesh's dp.  Then whether this process
    imported JAX or the JAX package, and the plain edge-core count."""
    import torch
    import torch.distributed as dist

    from ai2bmd_torch.host import build_fragment_index, example_pdb, load_protein
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.parallel import (EnsembleSimulation, ReplicaEnsemble, ShardedPotential,
                                       make_mesh)

    dev = rank.device
    prot = load_protein(example_pdb("chig"))
    fi = build_fragment_index(prot.atoms)
    cfg = ViSNetConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    P = torch.as_tensor(prot.positions, dtype=torch.float32, device=dev)
    out = {"backend": dist.get_backend(), "device": str(dev)}
    for n_dp, n_mp in meshes:
        mesh = make_mesh(n_dp, n_mp)
        sp = ShardedPotential.build(prot, fi, params, cfg, mesh, device=dev)
        delta = sp.initial_cap_delta(P)
        torch.cuda.synchronize()
        reset_launches()
        e, f = sp.energy_forces(P)
        torch.cuda.synchronize()
        cold = dict(LAUNCHES)
        reset_launches()
        sp.local_energy_forces(P, delta, 1)
        torch.cuda.synchronize()
        warm = dict(LAUNCHES)
        t0 = time.perf_counter()
        for _ in range(5):
            sp.local_energy_forces(P, delta, 1)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3 / 5

        ens = EnsembleSimulation.build(prot, fi, params, cfg, mesh, MESH_REPLICAS, device=dev)
        state = ens.initial_state(prot.positions, seed=MESH_SEED)
        first = ens.gather(state)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state = ens.run(state, MESH_STEPS)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (MESH_STEPS * ens.block.size)
        es = dict(LAUNCHES)
        every = ens.gather(state)

        rens = ReplicaEnsemble.build(prot, fi, params, cfg, MESH_REPLICAS,
                                     steps_per_call=MESH_STEPS, replica_chunk=2, device=dev,
                                     mesh=mesh)
        rstate = rens.run(rens.initial_state(prot.positions, seed=MESH_SEED), 1)
        rev = rens.gather(rstate)
        out[f"{n_dp}x{n_mp}"] = dict(
            sp_e=float(e), sp_f=f, cold=cold, warm=warm, eval_ms=eval_ms, step_ms=step_ms,
            es_launches=es, n_local=ens.block.size, layout=sp.layout, dp=mesh.get_local_rank("dp"),
            initial_f=first.forces, positions=every.positions, local_positions=state.positions,
            step=state.step, replica_positions=rev.positions)
    out["plain_edge_core"] = LAUNCHES["plain_edge_core"]
    out["imports_jax"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    out["imports_ai2bmd_tpu"] = any(m.startswith("ai2bmd_tpu") for m in sys.modules)
    return out


def mesh_references(torch, dev, prot):
    """The lone path the mesh is held against, on the card with phase 4's
    weights: the cold (E, F), the launches of a cold and of a warm
    evaluation, each replica's lone replay from that cold start on its own
    generator, and the one-card ReplicaEnsemble (chunks of 2)."""
    import numpy as np

    from ai2bmd_torch.frag import runtime as RT
    from ai2bmd_torch.host import build_fragment_index
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.parallel import ReplicaEnsemble, replica_generators

    pot, cfg, params = build_potential(torch, dev, prot, fused=False)
    P = torch.as_tensor(prot.positions, dtype=torch.float32, device=dev)
    d0 = RT.initial_cap_delta(pot.rt, P)
    torch.cuda.synchronize()
    reset_launches()
    e0, f0 = pot.energy_forces(P)
    torch.cuda.synchronize()
    cold = dict(LAUNCHES)
    reset_launches()
    pot.stateful_energy_forces(P, d0)
    torch.cuda.synchronize()
    warm = dict(LAUNCHES)
    masses = torch.as_tensor(prot.masses, dtype=torch.float32, device=dev)
    coeffs = L.LangevinCoeffs.build(prot.masses, 1.0, 300.0, 0.001, device=dev)
    lone = []
    for g in replica_generators(MESH_SEED, MESH_REPLICAS, dev):
        state = L.MDState(P, L.maxwell_boltzmann_velocities(g, prot.masses, 300.0), f0, e0,
                          aux=d0)
        for _ in range(MESH_STEPS):
            state = L.langevin_step(pot.stateful_energy_forces, coeffs, masses, state,
                                    generator=g)
        lone.append(state.positions.cpu().numpy())
    ens = ReplicaEnsemble.build(prot, build_fragment_index(prot.atoms), params, cfg,
                                MESH_REPLICAS, steps_per_call=MESH_STEPS, replica_chunk=2,
                                device=dev)
    one = ens.run(ens.initial_state(prot.positions, seed=MESH_SEED), 1)
    return dict(e=float(e0), f=f0.cpu().numpy(), cold=cold, warm=warm, lone=np.stack(lone),
                one_card=one.positions.cpu().numpy())


def check_mesh_world(label, outs, ref, card):
    """Phase 13's checks of one world's results (``outs``, one per rank)."""
    import numpy as np

    for r, out in enumerate(outs):
        need(not out["imports_jax"] and not out["imports_ai2bmd_tpu"],
             f"{label}: rank {r} imported JAX or the JAX package")
        need(out["plain_edge_core"] == 0, f"{label}: rank {r} ran the plain edge core")
    meshes = [k for k in outs[0] if re.fullmatch(r"\d+x\d+", k)]
    for key in meshes:
        n_dp, n_mp = map(int, key.split("x"))
        res = [out[key] for out in outs]
        mine = res[0]
        dE = abs(mine["sp_e"] - ref["e"])
        dF = float(np.abs(mine["sp_f"] - ref["f"]).max())
        dF0 = float(np.abs(mine["initial_f"] - ref["f"][None]).max())
        dx = float(np.abs(mine["positions"] - ref["lone"]).max())
        dx_ens = float(np.abs(mine["replica_positions"] - ref["one_card"]).max())
        print(f"  {label}, mesh {key} (layout {mine['layout']}): ShardedPotential vs the lone "
              f"path |dE| {dE:.3e} eV, max|dF| {dF:.3e} eV/A (limit {MESH_TOL}); "
              f"EnsembleSimulation's initial forces max|dF| {dF0:.3e}; {MESH_REPLICAS} replicas "
              f"after {MESH_STEPS} steps vs their lone replays max|dx| {dx:.3e} A (limit "
              f"{MESH_DX}); ReplicaEnsemble over dp={n_dp} vs one card max|dx| {dx_ens:.3e} A")
        need(dE <= MESH_TOL + 1e-7 * abs(ref["e"]), f"{label} {key}: |dE| {dE:.3e}")
        need(dF <= MESH_TOL and dF0 <= MESH_TOL, f"{label} {key}: max|dF| {dF:.3e} / {dF0:.3e}")
        need(dx <= MESH_DX, f"{label} {key}: replicas {dx:.3e} A from their lone replays")
        need(dx_ens <= MESH_DX, f"{label} {key}: ReplicaEnsemble {dx_ens:.3e} A from one card")
        need(mine["step"] == MESH_STEPS, f"{label} {key}: step {mine['step']}")
        for r, res_r in enumerate(res):
            for name in MESH_KERNELS:
                per_eval = {"cold": (res_r["cold"][name], ref["cold"][name]),
                            "warm": (res_r["warm"][name], ref["warm"][name]),
                            "step": (res_r["es_launches"][name],
                                     ref["warm"][name] * MESH_STEPS * res_r["n_local"])}
                for kind, (got, want) in per_eval.items():
                    need(got == want and got > 0,
                         f"{label} {key} rank {r}: {name} {got} launches ({kind}), expected {want}")
        for a in range(len(res)):
            for b in range(a + 1, len(res)):
                if res[a]["dp"] == res[b]["dp"]:
                    need(np.array_equal(res[a]["local_positions"], res[b]["local_positions"]),
                         f"{label} {key}: ranks {a} and {b} of one mp row hold other positions")
        if n_mp > 1:
            print(f"    the {n_mp} ranks of each mp row hold bitwise equal positions after "
                  f"{MESH_STEPS} steps")
        print(f"    launches an evaluation on each rank (K1 / K2 / K3 / K4): cold "
              f"{[mine['cold'][k] for k in MESH_KERNELS]}, warm "
              f"{[mine['warm'][k] for k in MESH_KERNELS]} (the lone path's: "
              f"{[ref['cold'][k] for k in MESH_KERNELS]}, {[ref['warm'][k] for k in MESH_KERNELS]});"
              f" rank 0: {mine['eval_ms']:.3f} ms a warm evaluation, {mine['step_ms']:.3f} ms a "
              f"replica-step ({label}; {card})")
    print(f"  {label}: backend {outs[0]['backend']}, ranks on {[o['device'] for o in outs]}; "
          f"no rank imported jax or ai2bmd_tpu; plain_edge_core 0 on every rank")
    return {key: outs[0][key]["warm"] for key in meshes}


def run_mesh(torch, dev, prot, card, root):
    """Phase 13: (a) an NCCL world of one rank, mesh 1 x 1; (b) a gloo world
    of two ranks sharing the card, meshes 1 x 2 and 2 x 1; (c) with two or
    more cards, NCCL over min(count, 4) of them at 1 x n and n x 1 and the
    CLI's --replicas 2n.  Returns rank 0's launches a warm evaluation in
    (b), by mesh."""
    import numpy as np

    from ai2bmd_torch.parallel.launch import launch

    t_phase = time.perf_counter()
    ref = mesh_references(torch, dev, prot)
    print(f"  lone references: cold E {ref['e']:.6f} eV; launches (K1 / K2 / K3 / K4) cold "
          f"{[ref['cold'][k] for k in MESH_KERNELS]}, warm {[ref['warm'][k] for k in MESH_KERNELS]}"
          f" ({time.perf_counter() - t_phase:.1f} s)")
    t0 = time.perf_counter()
    check_mesh_world("(a) NCCL, 1 rank",
                     launch(mesh_rank, 1, "cuda", args=([(1, 1)],), timeout_s=MESH_WORLD_S),
                     ref, card)
    print(f"  (a) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_launches = check_mesh_world(
        "(b) gloo, two processes sharing one card",
        launch(mesh_rank, 2, "cuda", args=([(1, 2), (2, 1)],), backend="gloo",
               timeout_s=MESH_WORLD_S), ref, card)
    print(f"  (b) took {time.perf_counter() - t0:.1f} s")
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"  (c) did not run: {n_cards} card on this machine (NCCL over several cards "
              f"needs two or more)")
    else:
        n = min(n_cards, 4)
        t0 = time.perf_counter()
        check_mesh_world(f"(c) NCCL, {n} cards",
                         launch(mesh_rank, n, "cuda", args=([(1, n), (n, 1)],),
                                timeout_s=MESH_WORLD_S), ref, card)
        d = os.path.join(root, "cli_mesh")
        # the CLI's mesh spans every card it sees: show it the first n
        out = _cli_wait("mesh", _cli_start(_cli_cmd(
            d, "--replicas", str(2 * n), "--sim-steps", "2", "--record-per-steps", "1",
            "--preeq-steps", "0", "--timestep", str(USER_DT_FS)), cards=n))
        with np.load(os.path.join(d, f"{2 * n}x-ensemble-final.npz")) as z:
            need(z["positions"].shape == (2 * n, len(prot), 3)
                 and bool(np.isfinite(z["positions"]).all()), "the CLI's mesh run")
        mesh = re.search(r"ensemble mesh dp=(\d+) x mp=(\d+) over (\d+) ranks", out)
        need(mesh is not None and tuple(map(int, mesh.groups())) == (1, n, n),
             f"the CLI did not run a 1 x {n} mesh over {n} ranks:\n{out[-2000:]}")
        print(f"  (c) --replicas {2 * n} over {n} cards (1 x {n}, EnsembleSimulation): exit 0, "
              f"{2 * n} replicas in the final npz ({time.perf_counter() - t0:.1f} s)")
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s ({card})")
    return mesh_launches


# Phase 14: the products' modes.  Every kernel with products (K1-K3, K5-K8
# and the lone helper) is built once a mode (ops/_build.py: b3, the
# production 3xTF32 split; highest, float32 FMA chains; default, one pass on
# bfloat16-rounded operands) and held to its mode's plain model
# (ops/tf32x3.py plain_mm).  K4 has no product.
MODES = ("b3", "highest", "default")
# the peak each mode's products run at on the H100 SXM (NVIDIA data sheet):
# three TF32 passes, float32 FMA, one TF32 pass
MODE_PEAK = {"b3": PEAK_TF32X3, "highest": PEAK_F32, "default": 495e12}
MODE_UNIT = {"b3": "3xTF32 tensor cores, 165 TFLOP/s", "highest": "float32 FMA, 67 TFLOP/s",
             "default": "one TF32 pass on bf16 values, 495 TFLOP/s"}
# b3 and highest: every output within EDGE_TOL x max(1, max|ref|) of the
# mode's plain model.  default: the helper's product and K1's outputs of one
# product of the inputs (DEFAULT_ONE_PRODUCT) within EDGE_TOL too.  Every
# other default output passes a chain of products, each of which rounds its
# operands to bfloat16: an intermediate that the kernel and the plain model
# compute a float32 rounding apart can round to neighbouring bfloat16
# values, a step of 2^-8 of that operand that the later products carry on
# (a one-ulp change of K6's inputs moves default's plain model by up to
# ~0.2 x 2^-8 of its scale, the float32 model by ~1e-6; bf16_sensitivity
# prints it).  Such an output passes within EDGE_TOL, or within 2^-8 x
# max(1, max|ref|) where its difference from the plain model, in the
# 2-norm, is at most BF16_SHARE of the difference the rounding makes there
# (default's plain model against highest's).  On the H100 the kernels read
# up to ~0.1 there, about what a one-ulp change of K6's inputs gives the
# plain model itself; a library that skipped the rounding reads 1.  The
# control (at the `controls` shapes of check_precision_kernels) holds the
# highest library to default's plain model and fails unless every kernel
# misses.
DEFAULT_ONE_PRODUCT = ("out", "zdkv", "zf", "df")
BF16_SHARE = 0.3
# the lone step's bar; JAX's own default mode moves forces by ~2.5e-3 eV/A
# (ai2bmd_tpu/ops/pallas/vismp.py:54), above it by design: printed, not held
PRECISION_STEP_LIMIT = {"b3": FORCE_LIMIT, "highest": FORCE_LIMIT, "default": None}
# the highest helper's error against float64, at most this many times
# cuBLAS float32's (allow_tf32 off) on the same operands
HIGHEST_VS_CUBLAS = 2.0
PRECISION_REPS = 10
# the variant of each kernel whose ms go into the kernels line
MAIN_VARIANT = {"edge_fwd": "edge_fwd update=1 store=1", "vislayer_fwd": "vislayer_fwd last=0",
                "vislayer_bwd": "vislayer_bwd last=0"}


def set_mm_mode(mode):
    """Select the kernels' products as a user does, through the JAX package's
    variable, and read it again (ops/vismp.py reads it once, at import)."""
    from ai2bmd_torch.ops import vismp as K

    os.environ[K.MM_ENV] = mode
    got = K.configure_mm_mode()
    need(got == mode, f"AI2BMD_KERNEL_MM_PRECISION={mode} gave {got}")


def only_mode(mode, what):
    """The launches since the last reset, which must all have come from
    ``mode``'s library (ops/_build.py LIBRARY_LAUNCHES, one a launch of a
    wrapper in ops.LAUNCHES): {"kernel@mode": launches}."""
    from ai2bmd_torch.ops import LAUNCHES, _build

    libs = {m: n for m, n in _build.LIBRARY_LAUNCHES.items() if n}
    kernels = {k: v for k, v in LAUNCHES.items() if v and k != "plain_edge_core"}
    need(kernels and list(libs) == [mode] and libs[mode] == sum(kernels.values()),
         f"{what} at {mode}: launches by library {libs}, by kernel {kernels}")
    return {f"{k}@{mode}": v for k, v in kernels.items()}


def quiet_compare(name, got, ref, tol):
    """compare() without a line per output: the largest abs error and the
    largest share of its bound, tol * max(1, max|ref|)."""
    worst, share = 0.0, 0.0
    for label, g, r in zip(ref.keys(), got, ref.values()):
        if r is None:
            need(g is None, f"{name}: {label} should be absent")
            continue
        need(g.shape == r.shape, f"{name}: {label} shape {tuple(g.shape)} != {tuple(r.shape)}")
        need(bool(g.isfinite().all()), f"{name}: {label} has non-finite values")
        err = float((g - r).abs().max())
        lim = tol * max(1.0, float(r.abs().max()))
        need(err <= lim, f"{name}: {label} differs from its mode's plain model by {err:.3e} "
                         f"(bound {lim:.3e})")
        worst, share = max(worst, err), max(share, err / lim)
    return worst, share


def default_misses(name, got, ref, exact):
    """A default-mode call's outputs ``got`` against default's plain model
    ``ref`` ({output: tensor}), with highest's plain model ``exact`` as the
    yardstick of the bfloat16 rounding: the outputs that miss their bounds
    (DEFAULT_ONE_PRODUCT, BF16_SHARE), the largest abs error and the largest
    share of the rounding's difference among outputs beyond EDGE_TOL."""
    misses, worst, share = [], 0.0, 0.0
    for (label, r), g, e in zip(ref.items(), got, exact.values()):
        if r is None:
            need(g is None, f"{name}: {label} should be absent")
            continue
        need(g.shape == r.shape, f"{name}: {label} shape {tuple(g.shape)} != {tuple(r.shape)}")
        need(bool(g.isfinite().all()), f"{name}: {label} has non-finite values")
        d = g - r
        err, scale = float(d.abs().max()), max(1.0, float(r.abs().max()))
        worst = max(worst, err)
        if err <= EDGE_TOL * scale:
            continue
        if label in DEFAULT_ONE_PRODUCT:
            misses.append(f"{label} {err:.3e} > {EDGE_TOL * scale:.3e} (one product, EDGE_TOL)")
            continue
        effect = float((e - r).norm())
        s = float(d.norm()) / effect if effect > 0 else math.inf
        share = max(share, s)
        if err > 2.0 ** -8 * scale or s > BF16_SHARE:
            misses.append(f"{label} {err:.3e} (2^-8 bound {2.0 ** -8 * scale:.3e}), "
                          f"{s:.3f} of the rounding's difference (bound {BF16_SHARE})")
    return misses, worst, share


def precision_specs(torch, K, FL, c, la, ws, B, A, H, nh):
    """Phase 14(a)'s calls on edge case ``c`` and layer inputs ``la`` (weights
    ``ws[last]``) in the current mode: (kernel, label, kernel call, its plain
    version taking ``mm`` as {output: tensor}, FLOPs, bytes)."""
    core, upd, g0 = c["core"], c["upd"], c["g_edge"]
    E = B * A * A
    fwd_keys = ("x_agg", "vec_agg", "df", "zdkv", "zs", "zf")
    specs = []
    for update in (True, False):
        for store in (True, False):
            kw = upd if update else {}

            def plain(mm, kw=kw, store=store):
                out = dict(zip(fwd_keys, K.edge_fwd_plain(*core, **kw, mm=mm)))
                if not store:
                    out["zdkv"] = out["zs"] = out["zf"] = None
                return out

            run = lambda kw=kw, store=store: K.edge_fwd(*core, **kw, store=store)
            specs.append(("edge_fwd", f"edge_fwd update={int(update)} store={int(store)}", run,
                          plain, 2 * E * (5 if update else 4) * H * H,
                          nbytes(*core[:12], *kw.values(), *run())))
    for name, args, flop in (("edge_bwd_msg", c["msg"], 8), ("edge_bwd_msg_rc", c["msg_rc"], 16)):
        run = lambda name=name, args=args: getattr(K, name)(*args)
        plain = lambda mm, name=name, args=args: dict(zip(
            MSG_KEYS, getattr(K, name + "_plain")(*args, mm=mm)))
        specs.append((name, name, run, plain, E * flop * H * H,
                      nbytes(*(a for a in args if hasattr(a, "numel")), *run())))
    for name, args, flop in (("edge_bwd_upd", c["upd_args"], 2),
                             ("edge_bwd_upd_rc", c["upd_rc"], 4)):
        run = lambda name=name, args=args: getattr(K, name)(*args, g_edge=g0.clone())
        plain = lambda mm, name=name, args=args: dict(zip(
            UPD_KEYS, getattr(K, name + "_plain")(*args, g0.clone(), mm=mm)))
        specs.append((name, name, run, plain, E * flop * H * H, nbytes(*args, g0, *run())))
    for last in (False, True):
        args = (la["x"], la["vec"], la["edge"], la["d_sh"], la["dist"], la["adj"], ws[last],
                CUTOFF, nh, last)
        flop_f, flop_b = layer_flop(B, A, last, H)
        run = lambda args=args: FL.vislayer_fwd(*args)
        plain = lambda mm, args=args: dict(zip(("x2", "vec2", "edge2", "x_agg"),
                                               FL.vislayer_fwd_plain(*args, mm=mm)))
        specs.append(("vislayer_fwd", f"vislayer_fwd last={int(last)}", run, plain, flop_f,
                      nbytes(*args[:6], *ws[last], *run())))
        # K6 on this mode's K5 x_agg, as the layer runs them
        bargs = (*args[:7], run()[3], la["gx2"], la["gvec2"], la["gedge2"], CUTOFF, nh, last)
        run = lambda bargs=bargs: FL.vislayer_bwd(*bargs)
        plain = lambda mm, bargs=bargs: dict(zip(("g_x", "g_vec", "g_edge", "g_d_sh", "g_dist"),
                                                 FL.vislayer_bwd_plain(*bargs, mm=mm)))
        specs.append(("vislayer_bwd", f"vislayer_bwd last={int(last)}", run, plain, flop_b,
                      nbytes(*bargs[:6], *ws[last], *bargs[7:11], *run())))
    return specs


def check_precision_helper(torch, dev, out):
    """The lone helper (tf32x3_mm) in each mode on phase 3's operands (H =
    256, K = 256 and 512 over Chignolin's largest batch's edge rows):
    against its mode's plain model within EDGE_TOL, bitwise repeats, its
    error against a float64 product beside cuBLAS float32's (allow_tf32 off;
    ``highest`` within HIGHEST_VS_CUBLAS times it), ms a call by CUDA
    events."""
    from ai2bmd_torch.ops import reset_launches
    from ai2bmd_torch.ops import tf32x3 as T

    gen = torch.Generator().manual_seed(3)
    rows = 4 * 40 * 40
    for kd in (H, 2 * H):
        x = (torch.randn((rows, kd), generator=gen) * 0.3).to(dev)
        w = (torch.randn((kd, H), generator=gen) * (2.0 / (kd + H)) ** 0.5).to(dev)
        ref64 = x.double() @ w.double()
        err = lambda y: float((y.double() - ref64).abs().max())
        e_32 = err(x @ w)
        for mode in MODES:
            set_mm_mode(mode)
            reset_launches()
            name = f"tf32x3_mm M={rows} K={kd} N={H} @{mode}"
            got = T.mm_tf32x3(x, w)
            e_mode, _ = quiet_compare(name, (got,), {"out": T.plain_mm(mode)(x, w)}, EDGE_TOL)
            need(torch.equal(got, T.mm_tf32x3(x, w)), f"{name}: two runs differ")
            e_k = err(got)
            ms = cuda_ms(torch, lambda: T.mm_tf32x3(x, w), PRECISION_REPS)
            only_mode(mode, name)
            print(f"  {name}: vs its plain model {e_mode:.2e}; vs float64 {e_k:.3e} (cuBLAS "
                  f"float32 {e_32:.3e}, ratio {e_k / e_32:.2f}); bitwise repeatable; "
                  f"{ms:.4f} ms ({2 * rows * kd * H / ms / 1e9:.1f} TFLOP/s)")
            if mode == "highest":
                need(e_k <= HIGHEST_VS_CUBLAS * e_32,
                     f"{name}: {e_k / e_32:.2f} times cuBLAS float32's error against float64")
            out[mode].setdefault("tf32x3_mm", {})[f"K={kd}"] = dict(
                max_abs_err=e_mode, err_vs_f64=e_k, cublas_f32_err_vs_f64=e_32, ms=ms)


def bf16_sensitivity(torch, FL, la, ws, nh):
    """How far a one-ulp change of K6's inputs (x, vec, edge and the
    cotangents, each element times 1 + s 2^-23, s in {-1, 0, 1} from a seed)
    moves the plain model in default and in highest: the largest share of
    the 2^-8 bound and of the rounding's difference (as default_misses takes
    them), per ``last``.  Printed beside the kernel's readings."""
    from ai2bmd_torch.ops import tf32x3 as T

    gen = torch.Generator(device=la["x"].device).manual_seed(5)
    nudge = lambda t: t * (1 + (torch.randint(-1, 2, t.shape, generator=gen,
                                              device=t.device).float() * 2.0 ** -23))
    lb = {k: nudge(v) if k in ("x", "vec", "edge", "gx2", "gvec2", "gedge2") else v
          for k, v in la.items()}
    out = {}
    for last in (False, True):
        run = lambda a, mm: FL.vislayer_bwd_plain(
            a["x"], a["vec"], a["edge"], a["d_sh"], a["dist"], a["adj"], ws[last], None,
            a["gx2"], a["gvec2"], a["gedge2"], CUTOFF, nh, last, mm=mm)
        dd, d2, ee, e2 = (run(la, T.mm_bf16_plain), run(lb, T.mm_bf16_plain),
                          run(la, T.mm_highest_plain), run(lb, T.mm_highest_plain))
        bound_share = max(float((b - a).abs().max()) / max(1.0, float(a.abs().max())) / 2.0 ** -8
                          for a, b in zip(dd, d2))
        rounding_share = max(float((b - a).norm()) / max(float((e - a).norm()), 1e-30)
                             for a, b, e in zip(dd, d2, ee))
        exact = max(float((b - a).abs().max()) for a, b in zip(ee, e2))
        out[f"last={int(last)}"] = dict(bound_share=bound_share, rounding_share=rounding_share,
                                         highest_max_abs=exact)
    return out


def check_precision_kernels(torch, dev):
    """Phase 14(a): each kernel with products in each mode at phase 3's
    shapes (the four lone batches and the whole molecule at H = 256 with 8
    heads; heads of 8, 16 and 64 channels at 4 x 40 and 1 x 176):
    held to its mode's plain model (b3 and highest within EDGE_TOL, default
    as default_misses says), bitwise repeats, and at 8 heads of 32 channels
    the ms of a call (CUDA events, which include the host's issue time)
    beside the mode's bound, at the lone batches also the device ms from a
    profiler trace while the profiler holds (it fails for the rest of a
    process once K7 has run at A = 752, in phase 7); every launch of a mode
    from its own library.  At 4 x 40 (32-channel heads) and 1 x 176
    (64-channel heads) the control: the highest library's outputs against
    default's plain model must miss for every kernel; at 1 x 176 with
    64-channel heads also bf16_sensitivity.  Returns {mode: {kernel:
    figures}}."""
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import reset_launches
    from ai2bmd_torch.ops import tf32x3 as T
    from ai2bmd_torch.ops import vislayer as FL
    from ai2bmd_torch.ops import vismp as K

    out = {m: {} for m in MODES}
    out["control"], out["sensitivity"] = {}, {}
    check_precision_helper(torch, dev, out)
    gen = torch.Generator().manual_seed(11)
    cases = ([(B, A, H, NH, "lone") for B, A in SHAPES]
             + [(B, A, H, NH, f"A={A}") for B, A in WHOLE_SHAPES]
             + [(B, A, h, nh, None) for h, nh in HEAD_CASES for B, A in HEAD_SHAPES]
             + [(*WIDE_TIMED, WIDE_H, WIDE_NH, "wide")])
    controls = ((4, 40, H, NH), (1, 176, 256, 4))
    weights = {}
    profiled = True
    for B, A, h, nh, where in cases:
        # the wide case: the wide instantiations of K1 (with the update and
        # the stash), K2, K3, K7, K8, K5 and K6 (both last) in highest and
        # default; b3 is phases 15's and 16's
        wide = where == "wide"
        if (h, nh) not in weights:
            p = init_params(ViSNetConfig(hidden_channels=h, num_heads=nh), gen)
            weights[h, nh] = {last: layer_weights_on(torch, FL, p, gen, last, dev, h, nh)
                              for last in (False, True)}
        tag = f"B={B} A={A} H={h} nh={nh}"
        control = (B, A, h, nh) in controls
        set_mm_mode("b3")
        c = edge_case(torch, K, gen, B, A, dev, h, nh)
        la = layer_inputs(torch, gen, B, A, dev, h)
        highest_out = {}
        for mode in (("highest", "default") if wide else MODES):
            set_mm_mode(mode)
            reset_launches()
            mm, line = T.plain_mm(mode), []
            for name, label, run, plain, flop, nbyte in precision_specs(
                    torch, K, FL, c, la, weights[h, nh], B, A, h, nh):
                if wide and label.startswith("edge_fwd") and label != MAIN_VARIANT["edge_fwd"]:
                    continue
                cell_name = f"{label} {tag} @{mode}"
                if mode == "default":
                    ref, exact = plain(mm), plain(T.mm_highest_plain)
                    misses, err, share = default_misses(cell_name, run(), ref, exact)
                    need(not misses, f"{cell_name}: " + "; ".join(misses))
                    if control:
                        ctl, _, ctl_share = default_misses(cell_name + " (control)",
                                                           highest_out.pop(label), ref, exact)
                        need(ctl, f"{cell_name}: the highest library's outputs pass as "
                                  f"default's (control)")
                        out["control"].setdefault(name, []).append(
                            dict(case=tag, label=label, misses=len(ctl), share=ctl_share))
                    del ref, exact
                else:
                    err, share = quiet_compare(cell_name, run(), plain(mm), EDGE_TOL)
                    if mode == "highest" and control:
                        highest_out[label] = run()
                a, b = run(), run()
                need(all((x is None and y is None) or bool(torch.equal(x, y))
                         for x, y in zip(a, b)), f"{cell_name}: two runs differ")
                del a, b
                res = out[mode].setdefault(name, {"max_abs_err": 0.0})
                res["max_abs_err"] = max(res["max_abs_err"], err)
                if mode == "default":
                    res["bf16_share"] = max(res.get("bf16_share", 0.0), share)
                if wide:
                    res["wide"] = max(res.get("wide", 0.0), err)
                    line.append(f"{label} {err:.1e} ({share:.3f})")
                    continue
                if where is None:
                    hw = res.setdefault("head_widths", {})
                    hw[f"DH={h // nh}"] = max(hw.get(f"DH={h // nh}", 0.0), err)
                    line.append(f"{label} {err:.1e} ({share:.3f})")
                    continue
                ms = cuda_ms(torch, run, PRECISION_REPS)
                dev_ms = None
                if where == "lone" and profiled:
                    dev_ms = device_ms(torch, run, PRECISION_REPS)
                    profiled = dev_ms is not None
                t_op, t_by = flop / MODE_PEAK[mode] * 1e3, nbyte / PEAK_BYTES * 1e3
                cell = res.setdefault(where, {}).setdefault(label, dict(
                    ms=0.0, device_ms=0.0, bound_ms=0.0, gflop=0.0, mbytes=0.0, ops_ms=0.0,
                    bytes_ms=0.0))
                cell["ms"] += ms
                cell["device_ms"] = (None if dev_ms is None or cell["device_ms"] is None
                                     else cell["device_ms"] + dev_ms)
                cell["bound_ms"] += max(t_op, t_by)
                cell["gflop"] += flop / 1e9
                cell["mbytes"] += nbyte / 1e6
                cell["ops_ms" if t_op >= t_by else "bytes_ms"] += max(t_op, t_by)
                line.append(f"{label} {err:.1e} ({share:.3f}) {ms:.4f} ms")
            out[mode].setdefault("launches", {})[tag] = only_mode(mode, tag)
            what = ("max|d| against its plain model (share of the EDGE_TOL bound)"
                    if mode != "default" else
                    "max|d| against its plain model (largest share of the rounding's "
                    "difference beyond EDGE_TOL)")
            print(f"  {tag} @{mode} ({what}{'' if where in (None, 'wide') else ', ms a call'}): "
                  + "; ".join(line))
        if control:
            print(f"  {tag} control, the highest library against default's plain model (outputs "
                  f"that miss; largest share of the rounding's difference): " + "; ".join(
                      f"{r['label']} {r['misses']} ({r['share']:.3f})"
                      for name, rows in out["control"].items() for r in rows if r["case"] == tag))
        if h // nh == 64 and A == 176:
            sens = out["sensitivity"][tag] = bf16_sensitivity(torch, FL, la, weights[h, nh], nh)
            print(f"  {tag}: a one-ulp change of K6's inputs moves default's plain model by "
                  + ", ".join(f"{k} {v['bound_share']:.3f} of the 2^-8 bound and "
                              f"{v['rounding_share']:.4f} of the rounding's difference"
                              for k, v in sens.items())
                  + "; highest's by " + ", ".join(f"{k} {v['highest_max_abs']:.2e}"
                                                 for k, v in sens.items()))
        del c, la, highest_out
        torch.cuda.empty_cache()
    set_mm_mode("b3")
    for mode in MODES:
        for res in out[mode].values():
            for where in [w for w in res if w == "lone" or w.startswith("A=")]:
                for cell in res[where].values():
                    cell["bound_by"] = ("operations" if cell.pop("ops_ms") >= cell.pop("bytes_ms")
                                        else "bytes")
    print(f"  ms a call summed over the four lone batches (H = 256, 8 heads), device (profiler) "
          f"/ events, each beside its mode's bound ("
          + "; ".join(f"{m}: {MODE_UNIT[m]}" for m in MODES) + ") and, for highest and "
          f"default, the design's estimate: the mode's bound at b3's share of its own:")
    for name in KERNELS:
        if name == "cap_grad":
            continue
        for label in sorted(out["b3"][name]["lone"]):
            cells = {m: out[m][name]["lone"][label] for m in MODES}
            b3 = cells["b3"]
            b3_ms = b3["device_ms"] if b3["device_ms"] is not None else b3["ms"]
            for m in ("highest", "default"):
                cells[m]["design_ms"] = cells[m]["bound_ms"] * b3_ms / b3["bound_ms"]
            print(f"    {label:28s} " + ", ".join(
                f"{m} {fmt_ms(cells[m]['device_ms'])} / {cells[m]['ms']:.4f} (bound "
                f"{cells[m]['bound_ms']:.4f}, {cells[m]['bound_by']}"
                + (f"; estimate {cells[m]['design_ms']:.4f}" if m != "b3" else "") + ")"
                for m in MODES))
    return out


def run_precision_step(torch, dev, prot, card, ref):
    """Phase 14(b): the lone Chignolin step at 9 x 256 (phase 4's weights)
    in each mode: cold caps and step 0 with the launch counters reset just
    before (every launch from the mode's library), step 0 against the CPU
    float64 run (``ref``, phase 4's; made here when None), the step captured
    by GraphedLangevin, TIMED_STEPS replays timed by CUDA events, a profiled
    window (kernels per step).  ``b3`` and ``highest`` fail above
    FORCE_LIMIT; ``default`` is printed beside it."""
    from ai2bmd_torch.md import GraphedLangevin
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.ops import reset_launches

    out = {}
    P = torch.as_tensor(prot.positions, dtype=torch.float32, device=dev)
    masses = torch.as_tensor(prot.masses, dtype=torch.float32, device=dev)
    coeffs = L.LangevinCoeffs.build(prot.masses, 1.0, 300.0, 0.001, device=dev)
    for mode in MODES:
        set_mm_mode(mode)
        print(f"  the lone step @{mode}")
        pot, cfg, params = build_potential(torch, dev, prot, fused=False)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        reset_launches()
        aux0 = pot.init_cap_delta(P)
        e0, f0, aux1 = pot.stateful_energy_forces(P, aux0)
        if ref is None:
            ref = slice_reference(torch, prot, cfg, params, pot, P, aux0, aux1)
        need(torch.equal(aux1, ref["aux1"]), f"{mode}: warm caps differ from the reference's "
                                             f"(K4 has no product and no mode)")
        dF, dF_fix = step0_errors(torch, pot, cfg, P, e0, f0, ref)
        state = L.MDState(P, L.maxwell_boltzmann_velocities(gen, prot.masses, 300.0), f0, e0,
                          aux=aux1)
        graphed = GraphedLangevin(pot.stateful_energy_forces, coeffs, masses, state, gen)
        launches = only_mode(mode, "the lone step (cold caps, step 0, warm-up and capture)")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(TIMED_STEPS):
            graphed.run(1)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / TIMED_STEPS
        s = graphed.state
        need(bool(s.positions.isfinite().all() and s.forces.isfinite().all()),
             f"{mode}: non-finite positions or forces in the graphed run")
        prof = profile_steps(torch, lambda _: graphed.run(1), None,
                             label=f"replayed steps @{mode}")
        limit = PRECISION_STEP_LIMIT[mode]
        print(f"  @{mode}: graphed {ms:.3f} ms/step (CUDA events, {TIMED_STEPS} replays), "
              f"{prof['kernels_per_step']:.0f} kernels per step; step 0 max|dF| {dF:.3e}, fixed "
              f"caps {dF_fix:.3e} eV/A against CPU float64 "
              f"({'limit' if limit else 'printed beside'} {FORCE_LIMIT}); launches {launches} "
              f"({card})")
        if limit is not None:
            need(dF <= limit and dF_fix <= limit,
                 f"{mode}: step-0 forces differ from float64 by {dF:.3e} / {dF_fix:.3e}")
        out[mode] = dict(ms_step=ms, kernels_per_step=prof["kernels_per_step"],
                         busy_share=prof["busy_share"], dF=dF, dF_fix=dF_fix, launches=launches)
        del pot, graphed, state, s
        torch.cuda.empty_cache()
    set_mm_mode("b3")
    return out


def run_precision_cli(torch, root):
    """Phase 14(c): ``python -m ai2bmd_torch --matmul-precision`` float32,
    tensorfloat32 and bfloat16 side by side on Chignolin (9 x 256, random
    weights from the seed), one step at TIMING_DT_FS recorded: each prints
    the precision it set, and the forces of its restart file (after one
    step from the same state; the positions part by ~dt^2 |dF| / m) against
    float32's, printed beside FORCE_LIMIT."""
    import numpy as np

    from ai2bmd_torch.utils.device import MATMUL_PRECISIONS as CLI_PRECISIONS

    d = lambda p: os.path.join(root, f"precision_{p}")
    t0 = time.perf_counter()
    procs = {p: _cli_start(_cli_cmd(d(p), "--preeq-steps", "0", "--sim-steps", "1",
                                    "--record-per-steps", "1", "--timestep", str(TIMING_DT_FS),
                                    "--matmul-precision", p))
             for p in CLI_PRECISIONS}
    outs = {p: _cli_wait(f"--matmul-precision {p}", proc) for p, proc in procs.items()}
    forces = {}
    for p, txt in outs.items():
        want = f"--matmul-precision {p} -> torch float32 matmul precision '{CLI_PRECISIONS[p]}'"
        need(want in txt, f"the CLI did not print {want!r}")
        with np.load(os.path.join(d(p), "chig-restart.npz")) as z:
            forces[p] = z["forces"].astype(np.float64)
    out = {}
    for p in CLI_PRECISIONS:
        if p != "float32":
            out[p] = float(np.abs(forces[p] - forces["float32"]).max())
            print(f"  CLI --matmul-precision {p}: prints torch's {CLI_PRECISIONS[p]!r}; forces "
                  f"after one step against float32's max|dF| {out[p]:.3e} eV/A (printed beside "
                  f"{FORCE_LIMIT})")
    print(f"  the three CLI runs took {time.perf_counter() - t0:.1f} s side by side")
    return out


def cublas_medium_vs_high(torch, dev):
    """torch's float32 matmul precision on the card: cuBLAS float32 products
    of edge-row operands under "highest", "high" and "medium", each against
    float64, and whether "medium" gives "high"'s bits (it did not run a
    bfloat16 pass for float32 operands: --matmul-precision bfloat16 is TF32
    on the card)."""
    gen = torch.Generator().manual_seed(12)
    x = (torch.randn((6400, H), generator=gen) * 0.3).to(dev)
    w = (torch.randn((H, 2 * H), generator=gen) * 0.06).to(dev)
    ref = x.double() @ w.double()
    y = {}
    try:
        for prec in ("highest", "high", "medium"):
            torch.set_float32_matmul_precision(prec)
            y[prec] = x @ w
    finally:
        torch.set_float32_matmul_precision("highest")
    err = {p: float((v.double() - ref).abs().max()) for p, v in y.items()}
    same = bool(torch.equal(y["medium"], y["high"]))
    one_bf16 = float(((x.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double())
                      - ref).abs().max())
    print(f"  cuBLAS float32 [6400, {H}] @ [{H}, {2 * H}] against float64: highest "
          f"{err['highest']:.3e}, high {err['high']:.3e}, medium {err['medium']:.3e} (one bf16 pass would be "
          f"{one_bf16:.3e}); medium bitwise equal to high: {same}")
    return dict(err=err, medium_equals_high=same, one_bf16_pass_err=one_bf16)


PHASE_AT = []                  # (phase, time.time() at its header) of the default run
T_WALL = time.time()


def phase(title):
    """Print a phase's header and note when it began (for prebuild_modes)."""
    PHASE_AT.append((title[3:].split(".")[0], time.time()))
    print(title)


def prebuild_modes():
    """Start the builds of the other products' modes' libraries (phase 14's)
    in a process of the lowest CPU priority, so that they take the host's
    idle cores while phases 4-13 run (after phase 3, whose kernel timings
    the host's load would slow: 170 s instead of ~76 beside them on one
    host), one mode after the other (each starts one nvcc a source);
    run_precision waits for it.  The process is killed at exit if it is
    still running."""
    import atexit

    others = tuple(m for m in MODES if m != "b3")
    code = ("import os, time\n"
            "os.nice(19)\n"
            "from ai2bmd_torch.ops import _build\n"
            "t0 = time.perf_counter()\n"
            f"for mode in {others!r}:\n"
            "    _build.build(mode)\n"
            "print(f'{time.perf_counter() - t0:.1f} {time.time()}')\n")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            cwd=os.path.dirname(os.path.abspath(__file__)), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    atexit.register(proc.kill)
    print(f"  the {' and '.join(others)} libraries build in the background (nice 19) for phase 14")
    return proc


def run_precision(torch, dev, prot, card, root, ref=None, prebuild=None, lone_step=True):
    """Phase 14: (a) the kernels in each mode, (b) the lone graphed step in
    each mode (``lone_step``: the default run leaves it to
    --precision-only, its time going to phase 19), (c) the CLI's
    --matmul-precision and cuBLAS under torch's precisions; (d), the
    per-mode launch counters, in (a) and (b).  ``prebuild``:
    prebuild_modes()'s process, waited for first."""
    from ai2bmd_torch.ops import _build

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    if prebuild is not None:
        out, err = prebuild.communicate()
        secs, done = (out.split() + ["?", "nan"])[:2]
        during = [p for p, at in PHASE_AT if at <= float(done)]
        print(f"  the background builds: exit {prebuild.returncode}, {secs} s of nvcc from "
              f"phase 4 on, beside phases 4-{during[-1] if during else '?'} (their host-clock "
              f"figures were taken beside it); waited {time.perf_counter() - t0:.1f} s for them"
              + (f"; the end of their errors:\n{err[-3000:]}" if prebuild.returncode else ""))

    def build(mode):           # each build starts one nvcc a source itself
        t = time.perf_counter()
        path = _build.build(mode)
        return path, time.perf_counter() - t

    with ThreadPoolExecutor(len(MODES)) as pool:   # the modes' builds side by side
        built = dict(zip(MODES, pool.map(build, MODES)))
    for mode in MODES:
        _build.library(mode)
        print(f"  the {mode} library: {built[mode][0]} ({built[mode][1]:.1f} s, the builds side "
              f"by side)")
    print(f"  the libraries ready in {time.perf_counter() - t0:.1f} s")
    print("  (a) K1-K3, K5-K8 and the lone helper in each mode against its plain model")
    kernels = check_precision_kernels(torch, dev)
    step = {}
    if lone_step:
        print("  (b) the lone graphed step (Chignolin, 9 x 256) in each mode")
        step = run_precision_step(torch, dev, prot, card, ref)
    else:
        print("  (b) the lone graphed step in each mode: left to --precision-only")
    print("  (c) the CLI's --matmul-precision; cuBLAS under torch's float32 matmul precisions")
    cli = run_precision_cli(torch, root)
    cublas = cublas_medium_vs_high(torch, dev)
    print(f"  phase 14 took {time.perf_counter() - t0:.1f} s ({card})")
    return dict(kernels=kernels, step=step, cli=cli, cublas=cublas)


# Phase 15: every head and hidden width through the edge kernels.  The
# (H, heads) cases of (a): heads of 128 and 256 channels at H = 256, heads
# of 48, 128 and 32 channels past 256, and H not a multiple of 32 (two
# heads of 24, five of 8), each at a fragment batch and a whole molecule;
# H = 1024 (8 heads of 128) at the fragment batch alone.
WIDE_CASES = ((256, 2), (256, 1), (384, 8), (512, 4), (512, 16), (48, 2), (40, 5))
WIDE_SHAPES = ((4, 40), (1, 176))
WIDE_TOP = (1024, 8)
# the case whose device ms, bound and share (a) reports, and the model of (b)-(e)
WIDE_H, WIDE_NH = 512, 4
# the depth of (b)-(d) and of phase 16's slice: 3 layers, while phase 19
# drives the wide kernels at full depth (9 x 1,280)
WIDE_LAYERS = 3
WIDE_TIMED = (4, 40)
# kernels the wide slice's replay trace must name (besides cap_grad_kernel)
WIDE_KERNELS = ("edge_fwd_wide", "edge_bwd_msg_wide", "edge_bwd_upd_wide")
WIDE_CLI_STEPS, WIDE_CLI_RECORD = 20, 10
# (f): a model at H % 32 != 0, whose edge weights the model pads once
PAD_LAYERS, PAD_H, PAD_NH = 2, 48, 2


def check_wide_case(torch, K, c, B, A, h, nh, out, timed):
    """K1 (four flag pairs), K2, K3, K7 and K8 on edge case ``c`` at width h
    with nh heads: against their plain versions within EDGE_TOL, bitwise
    repeats, K7/K8 against K2/K3 on K1's stash (bitwise).  Each kernel's
    largest error goes to out[kernel]["max_abs_err"]; when ``timed``, its
    ms in turns with its plain version, bound and share go to
    out[kernel]["timed"]."""
    tag = f"H={h} nh={nh} (DH={h // nh}) B={B} A={A}"
    core, upd, g0 = c["core"], c["upd"], c["g_edge"]
    fwd_keys = ("x_agg", "vec_agg", "df", "zdkv", "zs", "zf")
    E = B * A * A

    def check(name, label, run, ref, plain=None, flop=0.0, nbyte=0):
        err = compare(label, run(), ref, EDGE_TOL)
        bitwise(label, run)
        res = out.setdefault(name, {"max_abs_err": 0.0})
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if timed and plain is not None:
            t = in_turns(torch, run, plain)
            b = bound(nbyte, tc=flop)
            add_bound({}, b, t)
            dev = t["device_ms"] or t["ms"]
            res["timed"] = dict(case=tag, ms=t["ms"], device_ms=t["device_ms"],
                                plain_ms=t["plain_ms"], plain_device_ms=t["plain_device_ms"],
                                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                                gflop=b["gflop"], mbytes=b["mbytes"],
                                share=b["bound_ms"] / dev)

    for update in (True, False):
        for store in (True, False):
            label = f"edge_fwd {tag} update={int(update)} store={int(store)}"
            print(f"  {label}")
            kw = upd if update else {}
            ref = dict(zip(fwd_keys, K.edge_fwd_plain(*core, **kw)))
            if not store:
                ref["zdkv"] = ref["zs"] = ref["zf"] = None
            run = lambda kw=kw, store=store: K.edge_fwd(*core, **kw, store=store)
            main = update and store
            check("edge_fwd", label, run, ref,
                  (lambda kw=kw: K.edge_fwd_plain(*core, **kw)) if main else None,
                  2 * E * 5 * h * h, nbytes(*core[:12], *upd.values(), *run()) if main else 0)
    for name, args, flop in (("edge_bwd_msg", c["msg"], 8), ("edge_bwd_msg_rc", c["msg_rc"], 16)):
        label = f"{name} {tag}"
        print(f"  {label}")
        run = lambda name=name, args=args: getattr(K, name)(*args)
        plain = lambda name=name, args=args: getattr(K, name + "_plain")(*args)
        check(name, label, run, dict(zip(MSG_KEYS, plain())), plain, E * flop * h * h,
              nbytes(*(a for a in args if hasattr(a, "numel")), *run()))
    for name, args, flop in (("edge_bwd_upd", c["upd_args"], 2),
                             ("edge_bwd_upd_rc", c["upd_rc"], 4)):
        label = f"{name} {tag}"
        print(f"  {label} (g_edge summed in place)")
        run = lambda name=name, args=args: getattr(K, name)(*args, g_edge=g0.clone())
        plain = lambda name=name, args=args: getattr(K, name + "_plain")(*args, g0.clone())
        check(name, label, run, dict(zip(UPD_KEYS, plain())), plain, E * flop * h * h,
              nbytes(*args, g0, *run()))
    print("    K7 against K2 and K8 against K3 on K1's stash (bitwise):")
    compare(f"edge_bwd_msg_rc {tag}", K.edge_bwd_msg_rc(*c["msg_rc"]),
            dict(zip(MSG_KEYS, K.edge_bwd_msg(*c["msg"]))), 0.0)
    compare(f"edge_bwd_upd_rc {tag}", K.edge_bwd_upd_rc(*c["upd_rc"], g_edge=g0.clone()),
            dict(zip(UPD_KEYS, K.edge_bwd_upd(*c["upd_args"], g_edge=g0.clone()))), 0.0)


def wide_occupancy(torch, widths):
    """Shared memory per block, blocks per SM, registers, spill bytes and the
    source chunk's rows of the wide instantiations (K1's four flag pairs,
    K2/K7's centre pass, K3/K8's centre pass and g_edge product) at each
    (H, heads) of ``widths``, from the launchers' own sizes."""
    import ctypes

    from ai2bmd_torch.ops import _build

    lib = _build.library()
    I, P = ctypes.c_int, ctypes.c_void_p
    for fn, n in (("edge_fwd_wide_occupancy", 5), ("edge_bwd_msg_wide_occupancy", 4),
                  ("edge_bwd_upd_wide_occupancy", 3)):
        getattr(lib, fn).argtypes = [I] * n + [P]
        getattr(lib, fn).restype = I
    out = {}
    for h, nh in widths:
        rows = {}
        for label, fn, args in (
                ("K1 update store", "edge_fwd_wide_occupancy", (h, S, nh, 1, 1)),
                ("K1 update", "edge_fwd_wide_occupancy", (h, S, nh, 1, 0)),
                ("K1 store", "edge_fwd_wide_occupancy", (h, S, nh, 0, 1)),
                ("K1", "edge_fwd_wide_occupancy", (h, S, nh, 0, 0)),
                ("K2", "edge_bwd_msg_wide_occupancy", (h, S, nh, 0)),
                ("K7", "edge_bwd_msg_wide_occupancy", (h, S, nh, 1)),
                ("K3 centre", "edge_bwd_upd_wide_occupancy", (h, 0, 1)),
                ("K8 centre", "edge_bwd_upd_wide_occupancy", (h, 1, 1)),
                ("K3/K8 product", "edge_bwd_upd_wide_occupancy", (h, 0, 2))):
            o = (ctypes.c_int * 6)()
            rc = getattr(lib, fn)(*args, ctypes.cast(o, P))
            need(rc == 0, f"{fn}{args}: CUDA error {rc}")
            rows[label] = dict(smem_bytes=o[0], blocks_per_sm=o[1], registers=o[2],
                               spill_bytes=o[3], chunk_rows=o[4], tile_cols=o[5])
            print(f"  {label:16s} H={h} nh={nh} (wide): {o[0]} B shared memory per block, "
                  f"{o[1]} blocks per SM, {o[2]} registers, {o[3]} B local (spill) per thread, "
                  f"source chunks of {o[4]} rows in k-tiles of {o[5]} columns")
        out[f"H={h} nh={nh}"] = rows
    return out


def check_wide_kernels(torch, dev):
    """Phase 15(a): K1 (four flag pairs), K2, K3, K7 and K8 at WIDE_CASES x
    WIDE_SHAPES, WIDE_TOP and (WIDE_H, WIDE_NH) at every batch of SHAPES,
    each against its plain version, bitwise
    repeats, K7/K8 against K2/K3 on K1's stash; at WIDE_TIMED and (WIDE_H,
    WIDE_NH) the ms of each kernel beside its plain version, bound and
    share; the wide instantiations' occupancy.  Returns {kernel: figures}."""
    from ai2bmd_torch.ops import vismp as K

    gen = torch.Generator().manual_seed(13)
    out = {}
    cases = [(h, nh, B, A) for h, nh in WIDE_CASES for B, A in WIDE_SHAPES]
    cases.append((*WIDE_TOP, *WIDE_TIMED))
    # the wide slice's own width at every fragment batch it runs in (b)/(c)
    cases += [(WIDE_H, WIDE_NH, B, A) for B, A in SHAPES
              if (WIDE_H, WIDE_NH, B, A) not in cases]
    for h, nh, B, A in cases:
        need(not K.narrow_shapes(h, nh), f"H={h}, nh={nh} is a narrow shape")
        c = edge_case(torch, K, gen, B, A, dev, h, nh)
        per = {}
        check_wide_case(torch, K, c, B, A, h, nh, per,
                        timed=(h, nh, B, A) == (WIDE_H, WIDE_NH, *WIDE_TIMED))
        for name, res in per.items():
            o = out.setdefault(name, {"max_abs_err": 0.0, "cases": {}})
            o["max_abs_err"] = max(o["max_abs_err"], res["max_abs_err"])
            o["cases"][f"H={h} nh={nh} B={B} A={A}"] = res["max_abs_err"]
            if "timed" in res:
                o["timed"] = res["timed"]
        del c
        torch.cuda.empty_cache()
    # the narrow instantiations at phase 4's width on the same batch, timed
    # beside the wide case in the same process
    print(f"  the narrow instantiations at H={H}, nh={NH}, B x A = {WIDE_TIMED}, for the times")
    c = edge_case(torch, K, gen, *WIDE_TIMED, dev, H, NH)
    per = {}
    check_wide_case(torch, K, c, *WIDE_TIMED, H, NH, per, timed=True)
    for name, res in per.items():
        out[name]["narrow_timed"] = res["timed"]
    del c
    occ = wide_occupancy(torch, [(h, nh) for h, nh in WIDE_CASES] + [WIDE_TOP])
    for name, label in (("edge_fwd", "K1 update store"), ("edge_bwd_msg", "K2"),
                        ("edge_bwd_upd", "K3 centre"), ("edge_bwd_msg_rc", "K7"),
                        ("edge_bwd_upd_rc", "K8 centre")):
        out[name]["occupancy"] = {w: rows[label] for w, rows in occ.items()}
    out["occupancy"] = occ
    return out


def wide_potential(torch, dev, prot, remat=False, h=WIDE_H, nh=WIDE_NH, layers=N_LAYERS,
                   fused=False):
    """FragmentPotential for Chignolin at 9 x 512 with 4 heads of 128
    channels (or layers x h with nh heads; random weights, seed 0) on the
    card, as a user builds it; ``fused`` with AI2BMD_FUSED_LAYER=1, as a
    user selects the full-layer kernels."""
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
    from ai2bmd_torch.potentials import FragmentPotential

    cfg = ViSNetConfig(num_layers=layers, hidden_channels=h, num_heads=nh, remat=remat)
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


def run_widths(torch, dev, prot, card, root):
    """Phase 15: (a) the edge kernels at every width (check_wide_kernels);
    (b) Chignolin at WIDE_LAYERS x 512 with 4 heads through the wide
    instantiations of K1-K3, as phase 4 (one evaluation's launches those of
    WIDE_LAYERS layers; phase 19 holds its 9-layer slice to phase 4's); (c)
    the same weights with remat (K1 without a stash, K7/K8), one
    evaluation against (b)'s step 0; (d) the CLI on those weights written
    by save_converted; (f) a model at H % 32 != 0 against the CPU in
    float64, its edge weights padded at its first evaluation and not again,
    both evaluations within FORCE_LIMIT.  (e), AI2BMD_FUSED_LAYER=1 refused,
    is gone: phase 16 runs that model through K5/K6.
    Returns its figures, (b)'s step 0 and its float64 reference among them."""
    from ai2bmd_torch.models import visnet as V
    from ai2bmd_torch.models.checkpoint import save_converted
    from ai2bmd_torch.models.visnet import ViSNet
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.potentials import FragmentPotential

    t_phase = time.perf_counter()
    res = {}
    print("  (a) K1 (four flag pairs), K2, K3, K7 and K8 at every width against their plain "
          "versions")
    res["kernels"] = check_wide_kernels(torch, dev)
    res["a_s"] = time.perf_counter() - t_phase

    print(f"  (b) Chignolin, ViSNet {WIDE_LAYERS} x {WIDE_H}, {WIDE_NH} heads of "
          f"{WIDE_H // WIDE_NH} channels, through the wide K1-K3")
    pot, cfg, params = wide_potential(torch, dev, prot, layers=WIDE_LAYERS)
    need(not pot.cfg.fused_layer and not pot.cfg.plain_edge_core and not pot.cfg.remat,
         f"the wide model resolved to {pot.cfg}")
    launches, ms_step, P, aux0, aux1, e0, f0, graphed = drive(torch, dev, prot, pot, card,
                                                              WIDE_KERNELS)
    for name in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "cap_grad"):
        need(launches[name] > 0, f"kernel {name} was not launched on the wide path")
    for name in ("vislayer_fwd", "vislayer_bwd", "edge_bwd_msg_rc", "edge_bwd_upd_rc",
                 "tf32x3_mm"):
        need(launches[name] == 0, f"{name} ran on the wide slice")
    torch.cuda.synchronize()
    reset_launches()
    pot.stateful_energy_forces(P, aux1)
    torch.cuda.synchronize()
    batches = len(pot.rt.dip_buckets) + 1
    one = {n: LAUNCHES[n] for n in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "cap_grad")}
    want = {"edge_fwd": WIDE_LAYERS * batches, "edge_bwd_msg": WIDE_LAYERS * batches,
            "edge_bwd_upd": (WIDE_LAYERS - 1) * batches, "cap_grad": 1}
    print(f"  one warm evaluation launches {one} (phase 4's per batch and layer: {want})")
    need(one == want, f"the wide slice launches {one} an evaluation, not {want}")
    t0 = time.perf_counter()
    pot64 = FragmentPotential.build(prot, ViSNet(cfg, params).to(torch.float64), cfg,
                                    longrange="mm", device="cpu")
    cpu = torch.device("cpu")
    e_ref, f_ref, _ = pot64.stateful_energy_forces(P.to(cpu, torch.float64),
                                                   aux0.to(cpu, torch.float64))
    dF = float((f0.to(cpu, torch.float64) - f_ref).abs().max())
    print(f"  step 0 vs CPU float64 plain: |dE| {abs(float(e0) - float(e_ref)):.3e} eV, max|dF| "
          f"{dF:.3e} eV/A (limit {FORCE_LIMIT}); max|F| {float(f_ref.abs().max()):.3f} eV/A; "
          f"reference took {time.perf_counter() - t0:.1f} s")
    need(dF <= FORCE_LIMIT, f"wide step-0 forces differ from the float64 reference by {dF:.3e}")
    del pot64
    res.update(launches=launches, per_eval=one, ms_step_eager=ms_step, graphed=graphed,
               step0_max_dF=dF, ref=dict(aux0=aux0, e0=e0, f0=f0, e_ref=e_ref, f_ref=f_ref))

    print("  (c) the same weights with remat=True: one evaluation through K1 without its stash "
          "and K7/K8")
    pot_rc, _, _ = wide_potential(torch, dev, prot, remat=True, layers=WIDE_LAYERS)
    need(pot_rc.cfg.remat and not pot_rc.cfg.fused_layer, f"remat model resolved to {pot_rc.cfg}")
    torch.cuda.synchronize()
    reset_launches()
    e_rc, f_rc, _ = pot_rc.stateful_energy_forces(P, aux0)
    torch.cuda.synchronize()
    rc_launches = {n: v for n, v in LAUNCHES.items() if v}
    dF_rc = float((f_rc - f0).abs().max())
    print(f"  launches {rc_launches}; forces vs (b)'s step 0: max|dF| {dF_rc:.3e} eV/A, |dE| "
          f"{abs(float(e_rc) - float(e0)):.3e} eV (limit {FORCE_LIMIT})")
    need(LAUNCHES["edge_bwd_msg_rc"] == WIDE_LAYERS * batches
         and LAUNCHES["edge_bwd_upd_rc"] == (WIDE_LAYERS - 1) * batches
         and LAUNCHES["edge_fwd"] == WIDE_LAYERS * batches
         and LAUNCHES["edge_bwd_msg"] == 0 and LAUNCHES["edge_bwd_upd"] == 0,
         f"the remat evaluation launched {rc_launches}")
    need(dF_rc <= FORCE_LIMIT, f"remat forces differ from (b)'s step 0 by {dF_rc:.3e}")
    res.update(remat_launches=rc_launches, remat_max_dF=dF_rc)
    del pot_rc

    print("  (d) python -m ai2bmd_torch --ckpt-path on these weights")
    os.makedirs(root, exist_ok=True)
    npz = os.path.join(root, f"visnet-chig-{WIDE_LAYERS}x{WIDE_H}-{WIDE_NH}h.npz")
    save_converted(npz, params, cfg)
    d = os.path.join(root, "wide")
    t0 = time.perf_counter()
    txt = _cli_wait("wide", _cli_start(_cli_cmd(
        d, "--ckpt-path", npz, "--preeq-steps", "0", "--sim-steps", str(WIDE_CLI_STEPS),
        "--record-per-steps", str(WIDE_CLI_RECORD), "--timestep", str(USER_DT_FS))))
    need("Simulation finished!" in txt, "the wide CLI run did not finish")
    rows = _metrics(os.path.join(d, "chig-metrics.csv"))
    line = cli_model_line(txt, "edge-core kernels K1-K3")
    print(f"  exit 0 in {time.perf_counter() - t0:.1f} s, {WIDE_CLI_STEPS} steps at {USER_DT_FS} "
          f"fs; metrics ms/step {[r['ms_per_step'] for r in rows]}; {line!r}")
    need(f"ViSNet {WIDE_LAYERS} x {WIDE_H}, {WIDE_NH} heads:" in line, f"the CLI ran {line!r}")
    res["cli_line"] = line

    print(f"  (f) Chignolin, ViSNet {PAD_LAYERS} x {PAD_H}, {PAD_NH} heads (H % 32 != 0): the "
          f"edge weights padded once")
    pot_p, cfg_p, params_p = wide_potential(torch, dev, prot, h=PAD_H, nh=PAD_NH,
                                            layers=PAD_LAYERS)
    layers = pot_p.module.params()["layers"]

    def padded():
        return [V._padded_edge_weights(lp, PAD_H, li == PAD_LAYERS - 1)
                for li, lp in enumerate(layers)]

    torch.cuda.synchronize()
    reset_launches()
    e_p, f_p, _ = pot_p.stateful_energy_forces(P, aux0)
    first = padded()
    e_p2, f_p2, _ = pot_p.stateful_energy_forces(P, aux0)
    torch.cuda.synchronize()
    pad_launches = {n: v for n, v in LAUNCHES.items() if v}
    same = all(a is b for x, y in zip(first, padded()) for a, b in zip(x, y))
    need(same, "the padded edge weights were made again at the second evaluation")
    need(LAUNCHES["edge_fwd"] == 2 * PAD_LAYERS * batches
         and LAUNCHES["edge_bwd_upd"] == 2 * (PAD_LAYERS - 1) * batches
         and LAUNCHES["plain_edge_core"] == 0, f"the padded model launched {pad_launches}")
    pot64 = FragmentPotential.build(prot, ViSNet(cfg_p, params_p).to(torch.float64), cfg_p,
                                    longrange="mm", device="cpu")
    e_ref, f_ref, _ = pot64.stateful_energy_forces(P.to(cpu, torch.float64),
                                                   aux0.to(cpu, torch.float64))
    dF_p, dF_p2 = (float((f.to(cpu, torch.float64) - f_ref).abs().max()) for f in (f_p, f_p2))
    print(f"  launches over two evaluations {pad_launches}; vs CPU float64: |dE| "
          f"{abs(float(e_p) - float(e_ref)):.3e} eV, max|dF| {dF_p:.3e} and {dF_p2:.3e} eV/A "
          f"(limit {FORCE_LIMIT}); the two evaluations differ by "
          f"{float((f_p - f_p2).abs().max()):.3e} eV/A; the same padded weights at the second")
    need(max(dF_p, dF_p2) <= FORCE_LIMIT,
         f"the padded model's forces differ from float64 by {max(dF_p, dF_p2):.3e}")
    res.update(padded_max_dF=max(dF_p, dF_p2), padded_launches=pad_launches)
    del pot_p, pot64, layers, first
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"  wide slice ({WIDE_LAYERS} x {WIDE_H}, {WIDE_NH} heads): graphed "
          f"{graphed['ms_step']:.3f} ms/step "
          f"(events {graphed['ms_events']:.3f}), {graphed['kernels_per_step']:.0f} kernels a "
          f"step, {100 * graphed['busy_share']:.1f}% busy; eager {ms_step:.3f}; step 0 max|dF| "
          f"{dF:.3e}, remat {dF_rc:.3e}; (a) took {res['a_s']:.1f} s, phase 15 "
          f"{res['phase_s']:.1f} s ({card})")
    return res

# Phase 16: the full-layer kernels at every width, and one molecule past
# 1,024 slots.  (a) K5/K6 at phase 15(a)'s (H, heads, B x A) cases; the
# wide stages whose names the slice's replay trace must show.
LAYER_WIDE_KERNELS = ("vislayer_fwd_centre1_wide", "vislayer_bwd_centre_wide",
                      "vislayer_bwd_source_wide")
FWD_WIDE_STAGES = ("edge @ [W_dkv | W_f]", "centre pass 1", "v_e @ W_s", "centre pass 2",
                   "node rows", "edge rows padded")
BWD_WIDE_STAGES = ("node rows", "edge @ [W_dkv | W_f]", "edge-row pass", "g_wt", "v_e @ W_s",
                   "g_e @ W_s^T", "centre pass", "[g_dkv | g_zf] @ W^T", "source pass",
                   "LayerNorm rows", "gvec (vector rows)")
# (e): ACE-(ALA)110-NME as an alpha helix, 1,112 atoms, one molecule of
# 1,112 slots (23 source chunks of 48 rows and one of 8)
POLY_RES, POLY_PHI, POLY_PSI = 110, -57.0, -47.0
POLY_WIDTHS = ((H, NH), (WIDE_H, WIDE_NH))


def check_layer_case(torch, FL, ws, a, B, A, h, nh, out, timed=False):
    """K5 and K6 (on K5's x_agg), both ``last``, at width h with nh heads on
    layer inputs ``a`` and (padded) weights ``ws[last]``: against their
    plain versions within EDGE_TOL, bitwise repeats, and K6's recomputed
    a_ij against K5's: their s_e scratch (s = silu(v_ij W_s + b_s) adj of
    every edge row, which each builds from its own a_ij through the same
    product) bitwise equal.  Largest errors go to out[kernel]; with
    ``timed`` the updating layer's ms in turns with its plain version,
    bound and share go to out[kernel]["timed"]."""
    tag = f"H={h} nh={nh} (DH={h // nh}) B={B} A={A}"
    for last in (False, True):
        flop_f, flop_b = layer_flop(B, A, last, h)
        args = (a["x"], a["vec"], a["edge"], a["d_sh"], a["dist"], a["adj"], ws[last], CUTOFF,
                nh, last)
        label = f"vislayer_fwd {tag} last={int(last)}"
        print(f"  {label}")
        run = lambda args=args: FL.vislayer_fwd(*args)
        plain = lambda args=args: FL.vislayer_fwd_plain(*args)
        err = compare(label, run(), dict(zip(("x2", "vec2", "edge2", "x_agg"), plain())),
                      EDGE_TOL)
        bitwise(label, run)
        res = out.setdefault("vislayer_fwd", {"max_abs_err": 0.0})
        res["max_abs_err"] = max(res["max_abs_err"], err)
        fs, bs = {}, {}
        xagg = FL.vislayer_fwd(*args, scratch=fs)[3]
        bargs = (*args[:7], xagg, a["gx2"], a["gvec2"], a["gedge2"], CUTOFF, nh, last)
        blabel = f"vislayer_bwd {tag} last={int(last)}"
        print(f"  {blabel}")
        brun = lambda bargs=bargs: FL.vislayer_bwd(*bargs)
        bplain = lambda bargs=bargs: FL.vislayer_bwd_plain(*bargs)
        berr = compare(blabel, brun(), dict(zip(("g_x", "g_vec", "g_edge", "g_d_sh", "g_dist"),
                                                bplain())), EDGE_TOL)
        bitwise(blabel, brun)
        FL.vislayer_bwd(*bargs, scratch=bs)
        same = bool(torch.equal(fs["s_e"], bs["s_e"]))
        print(f"    K6's recomputed a_ij equal to K5's (their s_e scratch bitwise): {same}")
        need(same, f"{blabel}: K6's recomputed a_ij differ from K5's")
        del fs, bs
        res = out.setdefault("vislayer_bwd", {"max_abs_err": 0.0})
        res["max_abs_err"] = max(res["max_abs_err"], berr)
        if timed and not last:
            for name, k, pl, nbyte, flop in (
                    ("vislayer_fwd", run, plain, nbytes(*args[:6], *ws[last], *run()), flop_f),
                    ("vislayer_bwd", brun, bplain,
                     nbytes(*bargs[:6], *ws[last], *bargs[7:11], *brun()), flop_b)):
                print(f"  {name} {tag} last=0, timed")
                t = in_turns(torch, k, pl)
                b = bound(nbyte, tc=flop)
                add_bound({}, b, t)
                dev_ms = t["device_ms"] or t["ms"]
                out[name]["timed"] = dict(
                    case=tag, ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"],
                    plain_device_ms=t["plain_device_ms"], bound_ms=b["bound_ms"],
                    bound_by=b["bound_by"], gflop=b["gflop"], mbytes=b["mbytes"],
                    share=b["bound_ms"] / dev_ms)


def layer_wide_occupancy(torch, widths):
    """Shared memory per block, blocks per SM, registers, spill bytes and
    the centre passes' source-chunk rows of every stage of K5/K6's wide
    instantiation at each (H, heads) of ``widths``."""
    import ctypes

    from ai2bmd_torch.ops import _build

    lib = _build.library()
    I, P = ctypes.c_int, ctypes.c_void_p
    out = {}
    for fn, stages in (("vislayer_fwd_wide_occupancy", FWD_WIDE_STAGES),
                       ("vislayer_bwd_wide_occupancy", BWD_WIDE_STAGES)):
        getattr(lib, fn).argtypes = [I] * 4 + [P]
        getattr(lib, fn).restype = I
        for h, nh in widths:
            rows = out.setdefault(fn.split("_wide")[0], {}).setdefault(f"H={h} nh={nh}", {})
            for st, label in enumerate(stages):
                o = (ctypes.c_int * 6)()
                rc = getattr(lib, fn)(h, S, nh, st, ctypes.cast(o, P))
                need(rc == 0, f"{fn}({h}, {S}, {nh}, {st}): CUDA error {rc}")
                rows[label] = dict(smem_bytes=o[0], blocks_per_sm=o[1], registers=o[2],
                                   spill_bytes=o[3], chunk_rows=o[4], tile_cols=o[5])
            print(f"  {fn.split('_wide')[0]} H={h} nh={nh} (wide; shared bytes, blocks an SM, "
                  f"registers, spill bytes): " + "; ".join(
                      f"{k} {v['smem_bytes']}/{v['blocks_per_sm']}/{v['registers']}/"
                      f"{v['spill_bytes']}" for k, v in rows.items())
                  + f"; centre chunks of {o[4]} rows in k-tiles of {o[5]} columns")
    return out


def check_layer_widths(torch, dev):
    """Phase 16(a): K5 and K6 (both ``last``) at WIDE_CASES x WIDE_SHAPES,
    WIDE_TOP and (WIDE_H, WIDE_NH) at every batch of SHAPES, on the weights
    the model hands them (padded once at H % 32 != 0), as check_layer_case
    says; at WIDE_TIMED the wide (WIDE_H, WIDE_NH) and the narrow (H, NH)
    timed side by side; the wide stages' occupancy.  Returns {kernel:
    figures}."""
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import vislayer as FL
    from ai2bmd_torch.ops import vismp as K

    gen = torch.Generator().manual_seed(17)
    cases = [(h, nh, B, A) for h, nh in WIDE_CASES for B, A in WIDE_SHAPES]
    cases.append((*WIDE_TOP, *WIDE_TIMED))
    cases += [(WIDE_H, WIDE_NH, B, A) for B, A in SHAPES if (WIDE_H, WIDE_NH, B, A) not in cases]
    out, weights = {}, {}
    for h, nh, B, A in cases + [(H, NH, *WIDE_TIMED)]:
        narrow = (h, nh) == (H, NH)
        need(K.narrow_shapes(h, nh) == narrow, f"H={h}, nh={nh}: narrow_shapes")
        if (h, nh) not in weights:
            p = init_params(ViSNetConfig(hidden_channels=h, num_heads=nh), gen)
            weights[h, nh] = {last: FL.padded_layer_weights(
                layer_weights_on(torch, FL, p, gen, last, dev, h, nh), h)
                for last in (False, True)}
        per = {}
        check_layer_case(torch, FL, weights[h, nh], layer_inputs(torch, gen, B, A, dev, h), B, A,
                         h, nh, per,
                         timed=(B, A) == WIDE_TIMED and (h, nh) in ((WIDE_H, WIDE_NH), (H, NH)))
        for name, res in per.items():
            o = out.setdefault(name, {"max_abs_err": 0.0, "cases": {}})
            if narrow:
                o["narrow_timed"] = res["timed"]
                continue
            o["max_abs_err"] = max(o["max_abs_err"], res["max_abs_err"])
            o["cases"][f"H={h} nh={nh} B={B} A={A}"] = res["max_abs_err"]
            if "timed" in res:
                o["timed"] = res["timed"]
        torch.cuda.empty_cache()
    for name in ("vislayer_fwd", "vislayer_bwd"):
        w, n = out[name]["timed"], out[name]["narrow_timed"]
        print(f"  {name} at B x A = {WIDE_TIMED}: H={WIDE_H} nh={WIDE_NH} (wide) "
              f"{fmt_ms(w['device_ms'])} device (plain {fmt_ms(w['plain_device_ms'])}), "
              f"{100 * w['share']:.1f}% of its bound {w['bound_ms']:.4f} ms ({w['bound_by']}); "
              f"H={H} nh={NH} (narrow) {fmt_ms(n['device_ms'])} (plain "
              f"{fmt_ms(n['plain_device_ms'])}), {100 * n['share']:.1f}% of {n['bound_ms']:.4f}")
    occ = layer_wide_occupancy(torch, list(WIDE_CASES) + [WIDE_TOP])
    for name in ("vislayer_fwd", "vislayer_bwd"):
        out[name]["occupancy"] = occ[name]
    return out


def layer_launches(LAUNCHES):
    return {n: LAUNCHES[n] for n in ("vislayer_fwd", "vislayer_bwd", *EDGE_NAMES, "cap_grad")}


def run_layer_slice(torch, dev, prot, card, ref15):
    """Phase 16(b): Chignolin at WIDE_LAYERS x WIDE_H with WIDE_NH heads
    (phase 15(b)'s model) with AI2BMD_FUSED_LAYER=1, driven as phase 4b; one warm
    evaluation's launches (K5 and K6 a layer a batch, K1-K3 none); step 0
    against the CPU float64 run (phase 15(b)'s when it ran, from the same
    cold-cap offsets), beside 15(b)'s step 0 through K1-K3."""
    from ai2bmd_torch.models.visnet import ViSNet
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.potentials import FragmentPotential

    pot, cfg, params = wide_potential(torch, dev, prot, layers=WIDE_LAYERS, fused=True)
    launches, ms_step, P, aux0, aux1, e0, f0, graphed = drive(torch, dev, prot, pot, card,
                                                              LAYER_WIDE_KERNELS)
    for name in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "edge_bwd_msg_rc",
                 "edge_bwd_upd_rc", "tf32x3_mm"):
        need(launches[name] == 0, f"{name} ran on the wide full-layer slice")
    torch.cuda.synchronize()
    reset_launches()
    pot.stateful_energy_forces(P, aux1)
    torch.cuda.synchronize()
    one = layer_launches(LAUNCHES)
    batches = len(pot.rt.dip_buckets) + 1
    want = dict({n: 0 for n in one}, vislayer_fwd=WIDE_LAYERS * batches,
                vislayer_bwd=WIDE_LAYERS * batches, cap_grad=1)
    print(f"  one warm evaluation launches {one}")
    need(one == want, f"the wide full-layer slice launches {one} an evaluation, not {want}")
    cpu = torch.device("cpu")
    if ref15 is not None and torch.equal(aux0, ref15["aux0"]):
        e_ref, f_ref, t_ref = ref15["e_ref"], ref15["f_ref"], "phase 15(b)'s"
    else:
        t0 = time.perf_counter()
        pot64 = FragmentPotential.build(prot, ViSNet(cfg, params).to(torch.float64), cfg,
                                        longrange="mm", device="cpu")
        e_ref, f_ref, _ = pot64.stateful_energy_forces(P.to(cpu, torch.float64),
                                                       aux0.to(cpu, torch.float64))
        t_ref = f"made here in {time.perf_counter() - t0:.1f} s"
        del pot64
    dF = float((f0.to(cpu, torch.float64) - f_ref).abs().max())
    beside = "" if ref15 is None else (
        f"; 15(b)'s K1-K3 step 0 {float((ref15['f0'].to(cpu, torch.float64) - f_ref).abs().max()):.3e}"
        f", K5/K6 against it {float((f0 - ref15['f0']).abs().max()):.3e}")
    print(f"  step 0 vs CPU float64 plain ({t_ref}): |dE| {abs(float(e0) - float(e_ref)):.3e} eV, "
          f"max|dF| {dF:.3e} eV/A (limit {FORCE_LIMIT}){beside}")
    need(dF <= FORCE_LIMIT, f"wide full-layer step-0 forces differ from float64 by {dF:.3e}")
    return dict(launches=launches, per_eval=one, ms_step_eager=ms_step, graphed=graphed,
                step0_max_dF=dF, params=params, cfg=cfg, P=P, aux0=aux0)


def run_layer_cli(torch, root, cfg, params):
    """Phase 16(c): the CLI on the wide model's .npz with
    AI2BMD_FUSED_LAYER=1, WIDE_CLI_STEPS steps at USER_DT_FS: exit 0, the
    model line naming K5/K6's wide instantiations."""
    from ai2bmd_torch.models.checkpoint import save_converted

    os.makedirs(root, exist_ok=True)
    npz = os.path.join(root, f"visnet-chig-{WIDE_LAYERS}x{WIDE_H}-{WIDE_NH}h-layer.npz")
    save_converted(npz, params, cfg)
    d = os.path.join(root, "wide_layer")
    t0 = time.perf_counter()
    txt = _cli_wait("wide fused layer", _cli_start(_cli_cmd(
        d, "--ckpt-path", npz, "--preeq-steps", "0", "--sim-steps", str(WIDE_CLI_STEPS),
        "--record-per-steps", str(WIDE_CLI_RECORD), "--timestep", str(USER_DT_FS)),
        fused_layer=True))
    need("Simulation finished!" in txt, "the wide full-layer CLI run did not finish")
    rows = _metrics(os.path.join(d, "chig-metrics.csv"))
    line = cli_model_line(txt, "full-layer kernels K5/K6 (wide instantiations: K5, K6)")
    print(f"  exit 0 in {time.perf_counter() - t0:.1f} s, {WIDE_CLI_STEPS} steps at {USER_DT_FS} "
          f"fs; metrics ms/step {[r['ms_per_step'] for r in rows]}; {line!r}")
    need(f"ViSNet {WIDE_LAYERS} x {WIDE_H}, {WIDE_NH} heads:" in line, f"the CLI ran {line!r}")
    return line


def run_layer_padded(torch, dev, prot, P, aux0):
    """Phase 16(d): phase 15(f)'s model (PAD_LAYERS x PAD_H, PAD_NH heads, H %
    32 != 0) through K5/K6, two evaluations: each layer's weights padded at
    the first and not again, both within FORCE_LIMIT of the CPU float64
    run."""
    from ai2bmd_torch.models import visnet as V
    from ai2bmd_torch.models.visnet import ViSNet
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.potentials import FragmentPotential

    pot, cfg, params = wide_potential(torch, dev, prot, h=PAD_H, nh=PAD_NH, layers=PAD_LAYERS,
                                      fused=True)
    layers = pot.module.params()["layers"]
    padded = lambda: [V._padded_layer_weights(lp, PAD_H, PAD_NH, li == PAD_LAYERS - 1,
                                              torch.float32) for li, lp in enumerate(layers)]
    torch.cuda.synchronize()
    reset_launches()
    e1, f1, _ = pot.stateful_energy_forces(P, aux0)
    first = padded()
    e2, f2, _ = pot.stateful_energy_forces(P, aux0)
    torch.cuda.synchronize()
    got = layer_launches(LAUNCHES)
    same = all(a is b for x, y in zip(first, padded()) for a, b in zip(x, y))
    need(same, "the padded layer weights were made again at the second evaluation")
    batches = len(pot.rt.dip_buckets) + 1
    need(got["vislayer_fwd"] == 2 * PAD_LAYERS * batches and got["edge_fwd"] == 0
         and LAUNCHES["plain_edge_core"] == 0, f"the padded model launched {got}")
    cpu = torch.device("cpu")
    pot64 = FragmentPotential.build(prot, ViSNet(cfg, params).to(torch.float64), cfg,
                                    longrange="mm", device="cpu")
    e_ref, f_ref, _ = pot64.stateful_energy_forces(P.to(cpu, torch.float64),
                                                   aux0.to(cpu, torch.float64))
    dF1, dF2 = (float((f.to(cpu, torch.float64) - f_ref).abs().max()) for f in (f1, f2))
    print(f"  launches over two evaluations {got}; vs CPU float64: |dE| "
          f"{abs(float(e1) - float(e_ref)):.3e} eV, max|dF| {dF1:.3e} and {dF2:.3e} eV/A (limit "
          f"{FORCE_LIMIT}); the same padded weights at the second")
    need(max(dF1, dF2) <= FORCE_LIMIT, f"the padded model's forces differ by {max(dF1, dF2):.3e}")
    return dict(max_dF=max(dF1, dF2), launches=got)


def check_long_kernels(torch, dev, pos, out):
    """Phase 16(e), kernels: K1 (four flag pairs), K2, K3, K7, K8, K5 and K6
    (both ``last``) at B x A = 1 x len(pos) on the molecule's own graph, at
    POLY_WIDTHS: against their plain versions (where the plain version fits
    in the card's memory; said so where it does not), bitwise repeats, K7/K8
    against K2/K3 on K1's stash, K6's a_ij against K5's; CUDA-event ms a
    call.  Adds {kernel: {width: {"max_abs_err", "ms": {variant: ms},
    "not_compared": [variant]}}} to ``out``."""
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import vislayer as FL
    from ai2bmd_torch.ops import vismp as K

    A = pos.shape[0]
    gen = torch.Generator(device=dev).manual_seed(19)   # [A, A, H] inputs drawn on the card
    gen_w = torch.Generator().manual_seed(19)           # the weights, on the CPU
    fwd_keys = ("x_agg", "vec_agg", "df", "zdkv", "zs", "zf")
    for h, nh in POLY_WIDTHS:
        tag = f"H={h} nh={nh} B=1 A={A}"

        def check(name, variant, run, plain):
            label = f"{name} {tag}{variant}"
            print(f"  {label}")
            try:
                ref = plain()
            except torch.cuda.OutOfMemoryError:
                ref = None
            torch.cuda.empty_cache()
            res = out.setdefault(name, {}).setdefault(
                f"H={h} nh={nh}", {"max_abs_err": 0.0, "ms": {}, "not_compared": []})
            if ref is None:
                print("    the plain version does not fit in the card's memory: not compared")
                res["not_compared"].append(variant.strip() or name)
            else:
                res["max_abs_err"] = max(res["max_abs_err"],
                                         compare(label, run(), ref, EDGE_TOL))
                del ref
            bitwise(label, run)
            ms = res["ms"][variant.strip() or name] = cuda_ms(torch, run, 3)
            print(f"    {ms:.3f} ms a call (CUDA events)")

        c = edge_case(torch, K, gen, 1, A, dev, h, nh, pos=pos[None])
        core, upd, g0 = c["core"], c["upd"], c["g_edge"]
        for update in (True, False):
            for store in (True, False):
                kw = upd if update else {}

                def plain(kw=kw, store=store):
                    r = dict(zip(fwd_keys, K.edge_fwd_plain(*core, **kw)))
                    if not store:
                        r["zdkv"] = r["zs"] = r["zf"] = None
                    return r

                check("edge_fwd", f" update={int(update)} store={int(store)}",
                      lambda kw=kw, store=store: K.edge_fwd(*core, **kw, store=store), plain)
        for name, args in (("edge_bwd_msg", c["msg"]), ("edge_bwd_msg_rc", c["msg_rc"])):
            check(name, "", lambda name=name, args=args: getattr(K, name)(*args),
                  lambda name=name, args=args: dict(zip(MSG_KEYS,
                                                        getattr(K, name + "_plain")(*args))))
        for name, args in (("edge_bwd_upd", c["upd_args"]), ("edge_bwd_upd_rc", c["upd_rc"])):
            check(name, "",
                  lambda name=name, args=args: getattr(K, name)(*args, g_edge=g0.clone()),
                  lambda name=name, args=args: dict(zip(
                      UPD_KEYS, getattr(K, name + "_plain")(*args, g0.clone()))))
        print("    K7 against K2 and K8 against K3 on K1's stash (bitwise):")
        compare(f"edge_bwd_msg_rc {tag}", K.edge_bwd_msg_rc(*c["msg_rc"]),
                dict(zip(MSG_KEYS, K.edge_bwd_msg(*c["msg"]))), 0.0)
        compare(f"edge_bwd_upd_rc {tag}", K.edge_bwd_upd_rc(*c["upd_rc"], g_edge=g0.clone()),
                dict(zip(UPD_KEYS, K.edge_bwd_upd(*c["upd_args"], g_edge=g0.clone()))), 0.0)
        del c, core, upd, g0
        torch.cuda.empty_cache()
        p = init_params(ViSNetConfig(hidden_channels=h, num_heads=nh), gen_w)
        ws = {last: FL.padded_layer_weights(layer_weights_on(torch, FL, p, gen_w, last, dev, h, nh),
                                            h) for last in (False, True)}
        a = layer_inputs(torch, gen, 1, A, dev, h, pos=pos[None])
        for last in (False, True):
            args = (a["x"], a["vec"], a["edge"], a["d_sh"], a["dist"], a["adj"], ws[last],
                    CUTOFF, nh, last)
            check("vislayer_fwd", f" last={int(last)}",
                  lambda args=args: FL.vislayer_fwd(*args),
                  lambda args=args: dict(zip(("x2", "vec2", "edge2", "x_agg"),
                                             FL.vislayer_fwd_plain(*args))))
            fs, bs = {}, {}
            xagg = FL.vislayer_fwd(*args, scratch=fs)[3]
            bargs = (*args[:7], xagg, a["gx2"], a["gvec2"], a["gedge2"], CUTOFF, nh, last)
            check("vislayer_bwd", f" last={int(last)}",
                  lambda bargs=bargs: FL.vislayer_bwd(*bargs),
                  lambda bargs=bargs: dict(zip(("g_x", "g_vec", "g_edge", "g_d_sh", "g_dist"),
                                               FL.vislayer_bwd_plain(*bargs))))
            FL.vislayer_bwd(*bargs, scratch=bs)
            same = bool(torch.equal(fs["s_e"], bs["s_e"]))
            print(f"    K6's recomputed a_ij equal to K5's (s_e bitwise): {same}")
            need(same, f"vislayer_bwd {tag} last={int(last)}: K6's a_ij differ from K5's")
            del fs, bs, xagg, bargs
            torch.cuda.empty_cache()
        del a, ws
        torch.cuda.empty_cache()


def run_long_molecule(torch, dev, card):
    """Phase 16(e): one molecule past 1,024 slots, build_polyalanine(POLY_RES,
    POLY_PHI, POLY_PSI): its kernels at 1 x 1,112 (check_long_kernels), then
    ViSNetPotential at 9 x 256 with 8 heads (random weights, seed 0): one
    force evaluation with remat=True (K1 without a stash, K7/K8) and one
    through K5/K6 (AI2BMD_FUSED_LAYER=1), each with its launches, CUDA-event
    ms and peak memory; the two within FORCE_LIMIT."""
    import numpy as np

    from ai2bmd_torch.io.build import build_polyalanine
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.potentials import ViSNetPotential

    atoms = build_polyalanine(POLY_RES, phi=POLY_PHI, psi=POLY_PSI)
    pos = np.asarray(atoms.positions, np.float64)
    d = np.sqrt(((pos[:, None] - pos[None]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    A = len(pos)
    print(f"  ACE-(ALA){POLY_RES}-NME, phi {POLY_PHI}, psi {POLY_PSI}: {A} atoms, "
          f"{float((d < CUTOFF).sum(1).mean()):.1f} neighbours within {CUTOFF} A on average, "
          f"minimum distance {float(d.min()):.2f} A; {A} slots = {A // 48} chunks of 48 + "
          f"{A % 48}")
    need(A > 1024 and A % 8 == 0, f"{A} slots")
    out = {"A": A, "kernels": {}}
    P = torch.as_tensor(atoms.positions, dtype=torch.float32)
    check_long_kernels(torch, dev, P, out["kernels"])
    P = P.to(dev)
    cfg = ViSNetConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    evals = {}
    for route, kw in (("remat", dict(remat=True)), ("fused", dict(fused_layer=True))):
        c = ViSNetConfig(**kw)
        pot = ViSNetPotential.build(atoms.numbers, ViSNet(c, params), c, device=dev)
        need(pot.pad_to == A and pot.cfg.remat == (route == "remat")
             and pot.cfg.fused_layer == (route == "fused"), f"{route}: {pot.cfg}, {pot.pad_to}")
        pot.energy_forces(P)                      # warm-up (weights, caches)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        e, f = pot.energy_forces(P)
        end.record()
        torch.cuda.synchronize()
        launched = {n: v for n, v in LAUNCHES.items() if v}
        evals[route] = dict(ms=start.elapsed_time(end), launches=launched, e=e, f=f,
                            peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        need(bool(f.isfinite().all()) and f.shape == (A, 3), f"{route}: forces {tuple(f.shape)}")
        want = ({"edge_fwd": N_LAYERS, "edge_bwd_msg_rc": N_LAYERS,
                 "edge_bwd_upd_rc": N_LAYERS - 1} if route == "remat" else
                {"vislayer_fwd": N_LAYERS, "vislayer_bwd": N_LAYERS})
        need(launched == want, f"{route}: one evaluation launched {launched}, not {want}")
        print(f"  ViSNetPotential 9 x {H}, {NH} heads, {route}: one evaluation {evals[route]['ms']:.3f} "
              f"ms (CUDA events), launches {launched}, peak {evals[route]['peak_gib']:.2f} GiB "
              f"above the {base / 2 ** 30:.2f} held before ({card})")
        del pot
        torch.cuda.empty_cache()
    dF = float((evals["remat"]["f"] - evals["fused"]["f"]).abs().max())
    dE = abs(float(evals["remat"]["e"]) - float(evals["fused"]["e"]))
    print(f"  remat against K5/K6: max|dF| {dF:.3e} eV/A (limit {FORCE_LIMIT}), |dE| {dE:.3e} eV; "
          f"max|F| {float(evals['fused']['f'].abs().max()):.3f} eV/A")
    need(dF <= FORCE_LIMIT, f"the 1,112-slot molecule's two routes differ by {dF:.3e}")
    for ev in evals.values():
        del ev["e"], ev["f"]
    out.update(evals=evals, routes_max_dF=dF)
    return out


def run_layer_widths(torch, dev, prot, card, root, ref15=None):
    """Phase 16: (a) K5/K6 at every width (check_layer_widths); (b) the 9 x
    512, 4-head slice through them (run_layer_slice); (c) the CLI on it
    (run_layer_cli); (d) a 2 x 48, 2-head model (run_layer_padded); (e) one
    molecule of 1,112 slots (run_long_molecule).  Returns its figures."""
    t_phase = time.perf_counter()
    res = {}
    print("  (a) K5 and K6 at every width against their plain versions")
    res["kernels"] = check_layer_widths(torch, dev)
    res["a_s"] = time.perf_counter() - t_phase
    print(f"  (b) Chignolin, ViSNet {WIDE_LAYERS} x {WIDE_H}, {WIDE_NH} heads, "
          f"AI2BMD_FUSED_LAYER=1: the "
          f"wide K5/K6")
    sl = run_layer_slice(torch, dev, prot, card, ref15)
    res["slice"] = {k: v for k, v in sl.items() if k not in ("params", "cfg", "P", "aux0")}
    print("  (c) python -m ai2bmd_torch --ckpt-path on these weights, AI2BMD_FUSED_LAYER=1")
    res["cli_line"] = run_layer_cli(torch, root, sl["cfg"], sl["params"])
    print(f"  (d) Chignolin, ViSNet {PAD_LAYERS} x {PAD_H}, {PAD_NH} heads (H % 32 != 0), through "
          f"K5/K6")
    res["padded"] = run_layer_padded(torch, dev, prot, sl["P"], sl["aux0"])
    del sl
    torch.cuda.empty_cache()
    print(f"  (e) one molecule past 1,024 slots")
    t0 = time.perf_counter()
    res["long"] = run_long_molecule(torch, dev, card)
    res["e_s"] = time.perf_counter() - t0
    res["phase_s"] = time.perf_counter() - t_phase
    g = res["slice"]["graphed"]
    print(f"  wide full-layer slice ({WIDE_LAYERS} x {WIDE_H}, {WIDE_NH} heads): graphed "
          f"{g['ms_step']:.3f} "
          f"ms/step (events {g['ms_events']:.3f}), {g['kernels_per_step']:.0f} kernels a step, "
          f"{100 * g['busy_share']:.1f}% busy; step 0 max|dF| {res['slice']['step0_max_dF']:.3e}; "
          f"1,112 slots: remat {res['long']['evals']['remat']['ms']:.3f} ms, K5/K6 "
          f"{res['long']['evals']['fused']['ms']:.3f} ms an evaluation; (a) took "
          f"{res['a_s']:.1f} s, (e) {res['e_s']:.1f} s, phase 16 {res['phase_s']:.1f} s ({card})")
    return res


def layer_wide_entry(p16, name):
    """A K5/K6 figures of phase 16 for the kernels line: its largest error
    over the wide cases, the timed case beside the narrow one, the wide
    stages' occupancy, the wide slice's launches an evaluation."""
    res = p16["kernels"][name]
    return dict(max_abs_err=res["max_abs_err"], timed=res.get("timed"),
                narrow_timed=res.get("narrow_timed"), occupancy=res["occupancy"],
                slice_launches_per_eval=p16["slice"]["per_eval"].get(name, 0))


def long_entry(p16, name):
    """A kernel's figures at 1,112 slots (phase 16(e)): by width, its largest
    error against the plain version (None where that did not fit) and ms a
    call; its launches in one evaluation on each route."""
    lg = p16["long"]
    return dict(A=lg["A"], by_width=lg["kernels"].get(name),
                launches_per_eval={r: ev["launches"].get(name, 0)
                                   for r, ev in lg["evals"].items()})


def wide_entry(p15, name):
    """A kernel's figures of phase 15 for the kernels line: its largest error
    over the wide cases, the timed case's ms, bound and share, and the wide
    instantiation's occupancy by width."""
    res = p15["kernels"][name]
    return dict(max_abs_err=res["max_abs_err"], timed=res.get("timed"),
                narrow_timed=res.get("narrow_timed"), occupancy=res["occupancy"],
                slice_launches_per_eval=p15["per_eval"].get(name, 0),
                remat_launches_per_eval=p15["remat_launches"].get(name, 0))


def precision_entry(p14, name):
    """A kernel's figures of phase 14 for the kernels line, by mode: the main
    variant's ms over the four lone batches and at A = 176 with their
    bounds, the largest error against the mode's plain model, the head
    widths', and in default the largest share of the rounding's difference
    (default_misses)."""
    out = {}
    for mode in MODES:
        res = p14["kernels"][mode][name]
        label = MAIN_VARIANT.get(name, name)
        lone, whole = res["lone"][label], res["A=176"][label]
        out[mode] = dict(ms=lone["ms"], device_ms=lone["device_ms"], bound_ms=lone["bound_ms"],
                         bound_by=lone["bound_by"],
                         gflop=lone["gflop"], mbytes=lone["mbytes"], max_abs_err=res["max_abs_err"],
                         head_widths=res["head_widths"], whole_molecule_A176_ms=whole["ms"],
                         whole_molecule_A176_bound_ms=whole["bound_ms"], bound_peak=MODE_UNIT[mode],
                         step_ms=p14["step"].get(mode, {}).get("ms_step"),
                         design_ms=lone.get("design_ms"),
                         wide=res.get("wide"))
        if mode == "default":
            out[mode]["bf16_share"] = res["bf16_share"]
    return out


# ---------------------------------------------------------------------------
# Phase 17: the mixed-precision mode (ViSNetConfig.edge_dtype=torch.bfloat16)
# ---------------------------------------------------------------------------

MIXED_KERNELS = tuple(f"{n}_bf16" for n in EDGE_NAMES)
# the bfloat16 kernels' bound against their plain bfloat16 versions: about
# one bfloat16 step of the largest value (the two round the same float32
# values, so they part only where a float32 sum taken in another order
# crosses a rounding boundary)
MIXED_TOL = 2.0 ** -7
# 17(a): narrow at the lone batches and one molecule of 176 slots; wide at
# 4 x 40 with heads of 128 channels (H = 512) and of 24 (H = 48)
MIXED_NARROW = [*SHAPES, (1, 176)]
MIXED_WIDE = [(4, 40, 512, 4), (4, 40, 48, 2)]
# float32 evaluations of one molecule, held against the mode's shift
MIXED_MOLECULES = (("Chignolin", 176), ("ACE-(ALA)110-NME", 1112))


def mixed_compare(name, got, ref, label=""):
    """The largest error of each bfloat16 output against the plain version's
    (bound MIXED_TOL * max(1, max|plain|)) and the share of elements that
    differ at all; raises past the bound."""
    worst, shares = 0.0, []
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            need(g is None, f"{name}: output {i} should be absent")
            continue
        need(g.dtype == r.dtype and g.shape == r.shape, f"{name}: output {i} {g.dtype} "
             f"{tuple(g.shape)} against {r.dtype} {tuple(r.shape)}")
        need(bool(g.isfinite().all()), f"{name}: output {i} has non-finite values")
        gf, rf = g.float(), r.float()
        err, scale = float((gf - rf).abs().max()), float(rf.abs().max())
        need(err <= MIXED_TOL * max(1.0, scale),
             f"{name}: output {i} differs from its plain version by {err:.3e} (scale {scale:.3e})")
        worst = max(worst, err)
        shares.append(float((gf != rf).float().mean()))
    print(f"    {name}{label}: max|d| {worst:.3e}, share of elements that differ "
          + " ".join(f"{x:.4f}" for x in shares))
    return worst


def mixed_case(torch, K, gen, B, A, dev, h, nh):
    """Phase 3's edge_case at (B, A) and width h, cast to bfloat16: the
    arguments of the bfloat16 K1, K2, K3, K7 and K8 (K2/K3 on the bfloat16
    K1's stash), and the float32 case for the float32 kernels' times."""
    c = edge_case(torch, K, gen, B, A, dev, h, nh)
    bf = torch.bfloat16
    a = {n: t.to(bf) for n, t in c["a"].items()}
    core = tuple(a[n] for n in ("q", "k", "v", "vec", "edge", "d_sh", "dist", "adj", "w_dkv",
                                "b_dkv", "w_s", "b_s")) + (CUTOFF, nh)
    upd = dict(wt=a["wt"], wsrc=a["wsrc"], w_f=a["w_f"], b_f=a["b_f"])
    _, _, _, zdkv, zs, zf = K.edge_fwd(*core, **upd, store=True)
    g_x, g_va = c["msg"][11].to(bf), c["msg"][12].to(bf)
    g_df = c["upd_args"][5].to(bf)
    return dict(
        f32=c, core=core, upd=upd, g_edge=c["g_edge"].to(bf),
        msg=(*core[:4], zdkv, zs, *core[5:8], core[8], core[10], g_x, g_va, CUTOFF, nh),
        upd_args=(a["adj"], a["wt"], a["wsrc"], a["w_f"], zf, g_df),
        msg_rc=(*core[:12], g_x, g_va, CUTOFF, nh),
        upd_rc=(a["edge"], a["adj"], a["wt"], a["wsrc"], a["w_f"], a["b_f"], g_df))


def mixed_kernel_calls(K, c, mm=None):
    """{bf16 kernel name: (kernel call, plain call, float32 kernel call)} on
    case ``c``; K3/K8 sum into copies of the same message-path g_edge; the
    plain calls take the products ``mm`` (the exact product unless given)."""
    f = c["f32"]
    g, g32 = c["g_edge"], f["g_edge"]
    kw = {} if mm is None else {"mm": mm}

    def fwd_plain():   # the stash as the kernel stores it
        out = K.edge_fwd_bf16_plain(*c["core"], **c["upd"], **kw)
        return (*out[:3], *(z.to(g.dtype) for z in out[3:]))

    return {
        "edge_fwd_bf16": (lambda: K.edge_fwd(*c["core"], **c["upd"], store=True), fwd_plain,
                          lambda: K.edge_fwd(*f["core"], **f["upd"], store=True)),
        "edge_bwd_msg_bf16": (lambda: K.edge_bwd_msg(*c["msg"]),
                              lambda: K.edge_bwd_msg_bf16_plain(*c["msg"], **kw),
                              lambda: K.edge_bwd_msg(*f["msg"])),
        "edge_bwd_upd_bf16": (lambda: K.edge_bwd_upd(*c["upd_args"], g_edge=g.clone()),
                              lambda: K.edge_bwd_upd_bf16_plain(*c["upd_args"], g.clone(), **kw),
                              lambda: K.edge_bwd_upd(*f["upd_args"], g_edge=g32.clone())),
        "edge_bwd_msg_rc_bf16": (lambda: K.edge_bwd_msg_rc(*c["msg_rc"]),
                                 lambda: K.edge_bwd_msg_rc_plain(*c["msg_rc"], **kw),
                                 lambda: K.edge_bwd_msg_rc(*f["msg_rc"])),
        "edge_bwd_upd_rc_bf16": (lambda: K.edge_bwd_upd_rc(*c["upd_rc"], g_edge=g.clone()),
                                 lambda: K.edge_bwd_upd_rc_plain(*c["upd_rc"], g.clone(), **kw),
                                 lambda: K.edge_bwd_upd_rc(*f["upd_rc"], g_edge=g32.clone())),
    }


# multiply-adds of each kernel's products per edge cell, in units of H^2
# (phase 3's count for the float32 kernels: the bfloat16 instantiations run
# the same passes), split into (products of two bfloat16 operands, priced at
# the bfloat16 peak: the edge rows times W_dkv and W_f; products with a
# float32 operand computed in the kernel, priced at 3xTF32's: v_ij times
# W_s and every cotangent times a weight)
MIXED_PRODUCTS = {"edge_fwd_bf16": (3, 2), "edge_bwd_msg_bf16": (0, 4),
                  "edge_bwd_upd_bf16": (0, 1), "edge_bwd_msg_rc_bf16": (2, 6),
                  "edge_bwd_upd_rc_bf16": (1, 1)}


def check_mixed_kernels(torch, dev, results, cases=None):
    """Phase 17(a): each bfloat16 kernel against its plain bfloat16 version
    (K1 in its four flag pairs) at MIXED_NARROW and MIXED_WIDE (or the (B,
    A, H, heads) ``cases``), bitwise repeats, K7/K8 against K2/K3 on the
    bfloat16 K1's stash (printed: not bitwise in this mode), and at the lone
    batches the ms of a call (CUDA events) beside the float32 kernel's at
    the same shape and the plain version's, with the bytes, the bound and
    its share, summed into ``results`` for the kernels line."""
    from ai2bmd_torch.ops import vismp as K

    gen = torch.Generator().manual_seed(17)
    fwd_flags = ((True, True), (True, False), (False, True), (False, False))
    if cases is None:
        cases = [(B, A, H, NH) for B, A in MIXED_NARROW] + MIXED_WIDE
    for B, A, h, nh in cases:
        lone = (B, A) in SHAPES and h == H
        print(f"  B={B} A={A} H={h}, {nh} heads ({'narrow' if K.narrow_shapes(h, nh) else 'wide'})")
        c = mixed_case(torch, K, gen, B, A, dev, h, nh)
        plain = K.edge_fwd_bf16_plain(*c["core"], **c["upd"])
        for update, store in fwd_flags:
            kw = c["upd"] if update else {}
            run = lambda kw=kw, store=store: K.edge_fwd(*c["core"], **kw, store=store)
            ref = list(plain if update else K.edge_fwd_bf16_plain(*c["core"]))
            ref[3:] = [z.to(torch.bfloat16) if store and z is not None else None
                       for z in ref[3:]]
            got = run()
            res = results["edge_fwd_bf16"]
            res["max_abs_err"] = max(res["max_abs_err"], mixed_compare(
                "edge_fwd_bf16", got, ref, f" update={int(update)} store={int(store)}"))
            need(all(x is None or torch.equal(x, y) for x, y in zip(got, run())),
                 f"edge_fwd_bf16 update={int(update)} store={int(store)}: two runs differ")
        del plain
        calls = mixed_kernel_calls(K, c)
        outs = {}
        for name, (kern, ref, _) in calls.items():
            if name == "edge_fwd_bf16":
                continue
            outs[name] = kern()
            res = results[name]
            res["max_abs_err"] = max(res["max_abs_err"], mixed_compare(name, outs[name], ref()))
            need(all(torch.equal(x, y) for x, y in zip(outs[name], kern())),
                 f"{name}: two runs differ")
        for rc, stash in (("edge_bwd_msg_rc_bf16", "edge_bwd_msg_bf16"),
                          ("edge_bwd_upd_rc_bf16", "edge_bwd_upd_bf16")):
            d = max(float((x.float() - y.float()).abs().max())
                    for x, y in zip(outs[rc], outs[stash]))
            print(f"    {rc} against {stash} on K1's bfloat16 stash: max|d| {d:.3e} (the stash "
                  f"is rounded to bfloat16, the recompute is not)")
        print("    bitwise repeatable: every kernel")
        if not lone:
            continue
        for name, (kern, ref, kern32) in calls.items():
            ms, ms32, plain_ms = (cuda_ms(torch, fn, 20) for fn in (kern, kern32, ref))
            dev_ms, dev32 = device_ms(torch, kern), device_ms(torch, kern32)
            args = {"edge_fwd_bf16": (*c["core"][:12], *c["upd"].values()),
                    "edge_bwd_msg_bf16": c["msg"][:13], "edge_bwd_upd_bf16": c["upd_args"],
                    "edge_bwd_msg_rc_bf16": c["msg_rc"][:14],
                    "edge_bwd_upd_rc_bf16": c["upd_rc"]}[name]
            extra = (c["g_edge"],) if "upd" in name else ()
            n_bf, n_tc = (2 * B * A * A * u * h * h for u in MIXED_PRODUCTS[name])
            b = bound(nbytes(*[t for t in args if torch.is_tensor(t)], *extra,
                             *[t for t in kern() if t is not None]), tc=n_tc, bf16=n_bf)
            res = results[name]
            add_times(res, {"ms": ms, "plain_ms": plain_ms, "float32_ms": ms32,
                            "device_ms": dev_ms, "float32_device_ms": dev32})
            add_bound(res, b)
            print(f"    {name}: {ms:.4f} ms a call (events; device {fmt_ms(dev_ms)}) against the "
                  f"float32 kernel's {ms32:.4f} (device {fmt_ms(dev32)}) and the plain "
                  f"version's {plain_ms:.4f}; {b['mbytes']:.3f} MB, {n_bf / 1e9:.3f} GFLOP "
                  f"bf16 x bf16 at {PEAK_BF16 / 1e12:.0f} TFLOP/s + {n_tc / 1e9:.3f} GFLOP "
                  f"with a float32 operand at {PEAK_TF32X3 / 1e12:.0f}, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}), "
                  f"{100 * b['bound_ms'] / (dev_ms or ms):.1f}% of it")
        del c, calls, outs
        torch.cuda.empty_cache()


def check_mixed_modes(torch, dev):
    """Phase 17(b): every bfloat16 kernel (K1 with the update and the stash,
    K2, K3, K7, K8) at 4 x 40, narrow (H = 256, 8 heads) and wide (H = 48,
    2 heads), from the highest and default libraries, against its plain
    version with that mode's product (``vismp.route_mm``), bitwise repeats,
    every launch from the mode's library.  Returns {mode: {kernel: max abs
    err}, with "launches"}."""
    from ai2bmd_torch.ops import reset_launches
    from ai2bmd_torch.ops import vismp as K

    out = {}
    gen = torch.Generator().manual_seed(18)
    cases = [mixed_case(torch, K, gen, 4, 40, dev, h, nh) for h, nh in ((H, NH), (48, 2))]
    try:
        for mode in ("highest", "default"):
            set_mm_mode(mode)
            reset_launches()
            res = out[mode] = {}
            refs = []
            for c in cases:
                for name, (kern, ref, _) in mixed_kernel_calls(K, c, K.route_mm()).items():
                    got = kern()
                    need(all(torch.equal(x, y) for x, y in zip(got, kern())),
                         f"{name} ({mode}): two runs differ")
                    refs.append((name, got, ref))
            res["launches"] = only_mode(mode, "phase 17(b)")
            for name, got, ref in refs:
                res[name] = max(res.get(name, 0.0),
                                mixed_compare(name, got, ref(), f" ({mode})"))
    finally:
        set_mm_mode("b3")
    return out


def mixed_potential(torch, dev, prot, edge_dtype, device=None):
    """FragmentPotential for Chignolin at 9 x 256 (phase 4's weights, seed 0)
    with ``edge_dtype``, on ``device`` (the card unless given)."""
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
    from ai2bmd_torch.potentials import FragmentPotential

    cfg = ViSNetConfig(edge_dtype=edge_dtype)
    params = init_params(ViSNetConfig(), torch.Generator().manual_seed(0))
    pot = FragmentPotential.build(prot, ViSNet(cfg, params), cfg, longrange="mm",
                                  device=device or dev)
    return pot, cfg, params


def run_mixed_step(torch, dev, prot, card, ref=None):
    """Phase 17(c): the lone Chignolin step at 9 x 256 with edge_dtype=
    torch.bfloat16: one evaluation's launches (K1 36, K2 36, K3 32, K4 1,
    all bfloat16; no float32 edge kernel, no plain edge core), step 0 against
    the CPU float64 run of the float32 model (the mode's shift, printed) and
    against the same mixed step on the CPU, the kernels' plain versions
    (held to half that shift); the step captured as a CUDA graph and timed
    beside the float32 step's graph from the same call (``ref``: phase 4's;
    else run here)."""
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.ops import LAUNCHES, reset_launches, reset_plain_edge_core

    bf = torch.bfloat16
    pot, cfg, params = mixed_potential(torch, dev, prot, bf)
    need(pot.cfg.edge_dtype == bf and not pot.cfg.fused_layer and not pot.cfg.plain_edge_core,
         f"mixed potential config {pot.cfg}")
    P = torch.as_tensor(prot.positions, dtype=torch.float32, device=dev)
    aux0 = pot.init_cap_delta(P)
    torch.cuda.synchronize()
    reset_launches()
    reset_plain_edge_core()
    e0, f0, aux1 = pot.stateful_energy_forces(P, aux0)
    torch.cuda.synchronize()
    launched = {n: v for n, v in LAUNCHES.items() if v}
    batches = len(pot.rt.dip_buckets) + 1
    want = {"edge_fwd_bf16": N_LAYERS * batches, "edge_bwd_msg_bf16": N_LAYERS * batches,
            "edge_bwd_upd_bf16": (N_LAYERS - 1) * batches, "cap_grad": 1}
    print(f"  one evaluation launched {launched}")
    need(launched == want, f"one mixed evaluation launched {launched}, not {want}")
    cpu = torch.device("cpu")
    if ref is None:
        f32pot, f32cfg, _ = mixed_potential(torch, dev, prot, None)
        ref = slice_reference(torch, prot, f32cfg, params, f32pot, P, aux0, aux1)
        ref["f32_pot"] = f32pot
    shift = float((f0.to(cpu, torch.float64) - ref["f_ref"]).abs().max())
    cpu_pot, _, _ = mixed_potential(torch, dev, prot, bf, device="cpu")
    P_cpu, aux0_cpu = P.cpu(), aux0.cpu()

    def cpu_step():        # the mixed step on the CPU, in a thread beside the graphed drives
        t0 = time.perf_counter()
        return (*cpu_pot.stateful_energy_forces(P_cpu, aux0_cpu)[:2], time.perf_counter() - t0)

    wait_cpu = in_thread(cpu_step)
    masses = torch.as_tensor(prot.masses, dtype=torch.float32, device=dev)
    coeffs = L.LangevinCoeffs.build(prot.masses, 1.0, 300.0, 0.001, device=dev)
    out = {}
    for label, potential in (("mixed", pot), ("float32", ref.get("f32_pot"))):
        if potential is None:
            continue
        gen = torch.Generator(device=dev).manual_seed(0)
        state = L.MDState(P, L.maxwell_boltzmann_velocities(gen, prot.masses, 300.0), f0, e0,
                          aux=aux1)
        print(f"  the {label} step, graphed:")
        out[label] = drive_graphed(torch, potential.stateful_energy_forces, coeffs, masses, state,
                                   gen, card, ("cap_grad_kernel", *EDGE_KERNELS))
        edge = [n for n in out[label]["names"] if any(k in n for k in EDGE_KERNELS)]
        need(all(("bfloat16" in n) == (label == "mixed") for n in edge),
             f"the {label} replay ran {[short_name(n) for n in edge]}")
    print("  the mixed replay's edge kernels are all bfloat16 instantiations")
    (e_cpu, f_cpu, secs), waited = wait_cpu()
    d_cpu = float((f0.cpu() - f_cpu).abs().max())
    print(f"  step 0: against the CPU float64 float32 model max|dF| {shift:.3e} eV/A, |dE| "
          f"{abs(float(e0) - float(ref['e_ref'])):.3e} eV (the mode's shift); against the mixed "
          f"step on the CPU (the kernels' plain versions, {secs:.1f} s beside the graphed "
          f"drives, waited {waited:.1f} s for it) max|dF| {d_cpu:.3e} eV/A, |dE| "
          f"{abs(float(e0) - float(e_cpu)):.3e} eV ({d_cpu / shift:.3f} of the shift; limit "
          f"0.5); max|F| {float(f0.abs().max()):.3f} eV/A")
    need(0 < shift and d_cpu <= 0.5 * shift,
         f"the mixed step 0 differs from its CPU plain versions by {d_cpu:.3e} (shift {shift:.3e})")
    if ref is not None and "f32_pot" not in ref:
        need(torch.equal(aux0, ref["aux0"]), "the mixed run started from other cap offsets")
    reset_launches()
    out.update(launches=launched, shift=shift, d_cpu=d_cpu, max_f=float(f0.abs().max()))
    return out


def run_mixed_molecules(torch, dev, card, shift, max_f, fused_peak=None):
    """Phase 17(d): Chignolin as one molecule (176 slots) and ACE-(ALA)110-
    NME (1,112 slots) through ViSNetPotential at 9 x 256 with edge_dtype=
    bfloat16, one evaluation each on the stash route (K1-K3) and with remat
    (K1, K7, K8), each with its launches, ms (CUDA events) and peak memory;
    the two routes apart, and each against the float32 remat evaluation,
    held within the mode's shift (17(c)'s max|dF|, scaled by the molecule's
    largest force against the lone step's).  ``fused_peak``: phase 16(e)'s
    peak memory through K5/K6 at 1,112 slots, printed beside."""
    import numpy as np

    from ai2bmd_torch.host import example_pdb, load_protein
    from ai2bmd_torch.io.build import build_polyalanine
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.potentials import ViSNetPotential

    params = init_params(ViSNetConfig(), torch.Generator().manual_seed(0))
    out = {}
    for name, A in MIXED_MOLECULES:
        if A == 176:
            prot = load_protein(example_pdb("chig"))
            numbers, pos = prot.numbers, prot.positions
        else:
            atoms = build_polyalanine(POLY_RES, phi=POLY_PHI, psi=POLY_PSI)
            numbers, pos = atoms.numbers, atoms.positions
        P = torch.as_tensor(np.asarray(pos), dtype=torch.float32, device=dev)
        evals = {}
        for route, kw in (("float32 remat", dict(remat=True)),
                          ("mixed", dict(edge_dtype=torch.bfloat16)),
                          ("mixed remat", dict(edge_dtype=torch.bfloat16, remat=True))):
            c = ViSNetConfig(**kw)
            pot = ViSNetPotential.build(numbers, ViSNet(c, params), c, device=dev)
            need(pot.pad_to == A, f"{name}: {pot.pad_to} slots")
            pot.energy_forces(P)                  # warm-up (weights, casts)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_launches()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            e, f = pot.energy_forces(P)
            end.record()
            torch.cuda.synchronize()
            launched = {n: v for n, v in LAUNCHES.items() if v}
            tag = "_bf16" if "mixed" in route else ""
            want = ({f"edge_fwd{tag}": N_LAYERS, f"edge_bwd_msg_rc{tag}": N_LAYERS,
                     f"edge_bwd_upd_rc{tag}": N_LAYERS - 1} if "remat" in route else
                    {f"edge_fwd{tag}": N_LAYERS, f"edge_bwd_msg{tag}": N_LAYERS,
                     f"edge_bwd_upd{tag}": N_LAYERS - 1})
            need(launched == want, f"{name}, {route}: one evaluation launched {launched}")
            need(bool(f.isfinite().all()), f"{name}, {route}: non-finite forces")
            evals[route] = dict(ms=start.elapsed_time(end), f=f, launches=launched,
                                peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30)
            print(f"  {name} ({A} slots), {route}: one evaluation {evals[route]['ms']:.3f} ms "
                  f"(CUDA events), peak {evals[route]['peak_gib']:.2f} GiB above the "
                  f"{base / 2 ** 30:.2f} held before, launches {launched} ({card})")
            del pot
            torch.cuda.empty_cache()
        f32 = evals["float32 remat"]["f"]
        print(f"  {name}: peak GiB mixed {evals['mixed']['peak_gib']:.2f}, mixed remat "
              f"{evals['mixed remat']['peak_gib']:.2f}, float32 remat "
              f"{evals['float32 remat']['peak_gib']:.2f}"
              + (f", float32 through K5/K6 {fused_peak:.2f} (phase 16(e))"
                 if fused_peak is not None and A == 1112 else ""))
        limit = shift * max(1.0, float(f32.abs().max()) / max_f)
        apart = float((evals["mixed"]["f"] - evals["mixed remat"]["f"]).abs().max())
        print(f"  {name}: the two mixed routes apart max|dF| {apart:.3e} eV/A; max|F| "
              f"{float(f32.abs().max()):.3f} eV/A")
        for route in ("mixed", "mixed remat"):
            d = float((evals[route]["f"] - f32).abs().max())
            evals[route]["max_dF_float32"] = d
            print(f"  {name}, {route} against float32: max|dF| {d:.3e} eV/A (limit {limit:.3e}, "
                  f"the mode's shift)")
            need(d <= limit, f"{name}, {route}: forces differ from float32 by {d:.3e}")
        for ev in evals.values():
            del ev["f"]
        out[name] = dict(A=A, routes_apart=apart, **evals)
    return out


def run_mixed(torch, dev, prot, card, ref=None, fused_peak=None):
    """Phase 17: the mixed-precision mode, (a)-(d) above; (e) the float32
    edge and full-layer kernels' output hashes against adb0db2's (the commit
    before the bfloat16 instantiations), which they must equal.  Returns the
    phase's figures and the kernels' results for the kernels line."""
    t_phase = time.perf_counter()
    results = {n: {"max_abs_err": 0.0} for n in MIXED_KERNELS}
    print("  (a) the bfloat16 instantiations against their plain bfloat16 versions")
    check_mixed_kernels(torch, dev, results)
    print("  (b) every bfloat16 kernel in the highest and default libraries")
    modes = check_mixed_modes(torch, dev)
    print("  (c) the lone Chignolin step, 9 x 256, edge_dtype=torch.bfloat16")
    step = run_mixed_step(torch, dev, prot, card, ref)
    print("  (d) one molecule: 176 and 1,112 slots")
    mol = run_mixed_molecules(torch, dev, card, step["shift"], step["max_f"], fused_peak)
    print("  (e) the float32 kernels' outputs against adb0db2's")
    for name, want in {**edge_hashes(torch, dev), **layer_hashes(torch, dev)}.items():
        need(want == PARENT_HASHES[name], f"{name}: the float32 kernel's outputs changed")
    print("  every float32 edge and full-layer kernel's output hash equals adb0db2's")
    g, g32 = step["mixed"], step.get("float32")
    print(f"  mixed lone step graphed {g['ms_step']:.3f} ms/step (events {g['ms_events']:.3f}), "
          + (f"float32 {g32['ms_step']:.3f} (events {g32['ms_events']:.3f}); " if g32 else "")
          + f"{g['kernels_per_step']:.0f} kernels a step, {100 * g['busy_share']:.1f}% busy; "
          f"phase 17 {time.perf_counter() - t_phase:.1f} s ({card})")
    return dict(results=results, modes=modes, step=step, molecules=mol)


# adb0db2's float32 kernel output hashes (edge_hashes / layer_hashes on
# phase 3's fragment-shape inputs, H100): phase 17(e) holds the float32
# kernels to them, since the bfloat16 instantiations share their sources.
PARENT_HASHES = {
    "edge_fwd": "70dbdd0adf5465ac3fe2aefab30a16d69728ed15bafde4e228529096df3200ea",
    "edge_bwd_msg": "f11d1a750cd27598e1798c1d3d7ae3522228acdf7882cfe11504d3a3b7a1ae50",
    "edge_bwd_upd": "c7a487d1b812fb6040e311e84d3d7555d98705448707a5b912243d7f058fb0cd",
    "edge_bwd_msg_rc": "f11d1a750cd27598e1798c1d3d7ae3522228acdf7882cfe11504d3a3b7a1ae50",
    "edge_bwd_upd_rc": "c7a487d1b812fb6040e311e84d3d7555d98705448707a5b912243d7f058fb0cd",
    "vislayer_fwd": "e1aa6e9cd815b4f95be3316bf8ae73e7024608520bb0c2d3f62b4db6a5e3cf45",
    "vislayer_bwd": "ae197aa0ad072b77b90c83425f507e0819c343f4f82fd34390ef9d7bd3bbc8ee",
}


def mixed_entry(p17, name):
    """A bfloat16 kernel's kernels-line entry: phase 17(a)'s figures summed
    over the lone batches, its launches on the mixed main path (17(c); K7/K8
    from 17(d)'s 1,112-slot remat evaluation) and 17(b)'s errors by mode."""
    base = name[:-len("_bf16")]
    src, rep = KERNELS[base]
    launches = p17["step"]["launches"].get(name, 0)
    if name.endswith("_rc_bf16"):
        launches = p17["molecules"]["ACE-(ALA)110-NME"]["mixed remat"]["launches"].get(name, 0)
    need(launches > 0, f"{name} was not launched on the mixed path")
    res = dict(p17["results"][name])
    return {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches,
            "bound_peak": (f"bf16 x bf16 products at {PEAK_BF16 / 1e12:.0f} TFLOP/s, "
                           f"float32-operand products at 3xTF32's "
                           f"{PEAK_TF32X3 / 1e12:.0f} TFLOP/s (tensor cores)"),
            "storage": "bfloat16",
            "modes": {m: v.get(name) for m, v in p17["modes"].items() if name in v},
            **finish(res)}


# Phase 18: the native trajectory writer (ai2bmd_torch.runtime) on the box.
RUNTIME_FRAMES = 10           # frames of the box through each writer (18b)
RUNTIME_JITTER = 0.01         # A: each frame moved by N(0, this) from chig-preeq.pdb, seed 0
WRITER_STEPS = 30             # 18(c): the solvated Simulator.run, recording every RECORD steps


def runtime_build():
    """Phase 18(a): the library, built by g++ under build/ai2bmd_torch/ at
    this process's first use (phase 6's Simulator in the whole script)."""
    from ai2bmd_torch import runtime

    runtime.library()
    info = dict(runtime.BUILD_INFO)
    print(f"  (a) {info['path']}: built in {info['seconds']:.2f} s at this process's first use, "
          f"cached {info['cached']}")
    return info


def runtime_frames(root, card):
    """Phase 18(b): RUNTIME_FRAMES frames of the box (17,882 atoms, its cell)
    through the native writer and through the Python writers: ms a frame
    (native: the submit), the native close's drain, pending() after the
    submits; the XYZ bytes equal, the DCDs equal apart from the title record,
    read_dcd giving the frames back exactly."""
    import numpy as np

    from ai2bmd_torch import runtime
    from ai2bmd_torch.host import load_protein
    from ai2bmd_torch.io import trajectory as TT

    box = load_protein(SOLVATED)
    n = len(box.numbers)
    need(n == 17882 and box.cell is not None, f"the box: {n} atoms, cell {box.cell}")
    rng = np.random.default_rng(0)
    frames = [(box.positions + rng.normal(scale=RUNTIME_JITTER, size=box.positions.shape))
              .astype(np.float32) for _ in range(RUNTIME_FRAMES)]
    d = os.path.join(root, "runtime")
    os.makedirs(d, exist_ok=True)
    path = lambda name: os.path.join(d, name)
    kw = dict(timestep_fs=SOLV_DT_FS, save_interval=RECORD, cell=box.cell)
    w = runtime.AsyncTrajectoryWriter(path("native.dcd"), path("native.xyz"), box.numbers, **kw)
    submit = []
    for k, f in enumerate(frames):
        t0 = time.perf_counter()
        w.write(f, energy=-1.5 * k, step=RECORD * k)
        submit.append(1e3 * (time.perf_counter() - t0))
    pending = w.pending()
    t0 = time.perf_counter()
    w.close()
    drain = 1e3 * (time.perf_counter() - t0)
    x = TT.XYZTrajectory(path("python.xyz"), box.numbers)
    dc = TT.DCDTrajectory(path("python.dcd"), n, **kw)
    py = []
    for k, f in enumerate(frames):
        t0 = time.perf_counter()
        x.write(f, energy=-1.5 * k, step=RECORD * k)
        dc.write(f)
        py.append(1e3 * (time.perf_counter() - t0))
    x.close()
    dc.close()
    raw = {k: open(path(k), "rb").read() for k in ("native.dcd", "python.dcd", "native.xyz",
                                                   "python.xyz")}
    title = slice(4 + 84 + 4, 4 + 84 + 4 + 4 + 84 + 4)     # the DCD's title record
    nat, pyd = raw["native.dcd"], raw["python.dcd"]
    xyz_equal = raw["native.xyz"] == raw["python.xyz"]
    dcd_equal = (len(nat) == len(pyd) and nat[:title.start] == pyd[:title.start]
                 and nat[title.stop:] == pyd[title.stop:])
    back, cells = TT.read_dcd(path("native.dcd"), return_cells=True)
    exact = back.shape == (RUNTIME_FRAMES, n, 3) and bool((back == np.stack(frames)).all())
    out = dict(native_ms=sum(submit) / len(submit), python_ms=sum(py) / len(py), drain_ms=drain,
               pending=pending, xyz_mb=len(raw["native.xyz"]) / 1e6,
               dcd_mb=len(nat) / 1e6)
    print(f"  (b) {RUNTIME_FRAMES} frames of {n} atoms with the cell: native {out['native_ms']:.3f} "
          f"ms a frame (the submit; each {[round(t, 3) for t in submit]}), pending() after the "
          f"submits {pending}, close() drained in {drain:.1f} ms; Python writers "
          f"{out['python_ms']:.3f} ms a frame (each {[round(t, 3) for t in py]}); XYZ "
          f"{out['xyz_mb']:.2f} MB, DCD {out['dcd_mb']:.2f} MB ({card})")
    print(f"  (b) XYZ bytes equal: {xyz_equal}; DCD bytes equal apart from the title record: "
          f"{dcd_equal} (titles {nat[title][8:46]!r} / {pyd[title][8:31]!r}); read_dcd gives the "
          f"frames back exactly: {exact}, the cell on every frame: "
          f"{cells is not None and bool((cells == box.cell).all())}")
    need(xyz_equal, "the native XYZ differs from the Python writer's")
    need(dcd_equal, "the native DCD differs from the Python writer's outside the title")
    need(exact and cells is not None and bool((cells == box.cell).all()),
         "read_dcd did not give the frames and cells back")
    return out


def writer_runs(torch, sim, state, root):
    """Phase 18(c)'s library half, run where phase 9b's solvated Simulator
    (flexible water, its step captured) is alive: WRITER_STEPS steps recording
    every RECORD, once through the native writer and once through the Python
    writers (this script makes the runtime unavailable for that call, as a
    machine without g++ would), from the same state and generator state.
    Returns each run's metrics rows (ms/step of each record interval; the
    first holds no write), the steady mean (rows 2 on: the previous record's
    writes and restart file included) and the run's wall ms/step with the
    final close."""
    from ai2bmd_torch import runtime
    from ai2bmd_torch.io.trajectory import read_dcd

    def unavailable():
        raise RuntimeError("native runtime unavailable: made so by chip_smoke.py")

    gen = sim.generator.get_state()
    saved = runtime.library
    metrics = os.path.join(sim.log_dir, f"{sim.prot_name}-metrics.csv")
    out = {}
    for name in ("native", "python"):
        sim.generator.set_state(gen)
        if os.path.exists(metrics):
            os.remove(metrics)            # the CSV appends: each run reads its own rows
        lines = []
        if name == "python":
            runtime.library = unavailable
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final = sim.run(state, WRITER_STEPS, log=lines.append, traj_suffix=f"-{name}")
            wall = 1e3 * (time.perf_counter() - t0) / WRITER_STEPS
        finally:
            runtime.library = saved
        want = "native writer" if name == "native" else "Python writers"
        line = [ln for ln in lines if ln.startswith("trajectory:")]
        need(len(line) == 1 and line[0].startswith(f"trajectory: {want} (XYZ, DCD"),
             f"the {name} run logged {line}")
        frames = read_dcd(os.path.join(sim.log_dir, f"{sim.prot_name}-traj-{name}.dcd"))
        need(frames.shape == (WRITER_STEPS // RECORD, 17882, 3)
             and bool(torch.as_tensor(frames).isfinite().all())
             and bool(final.positions.isfinite().all()), f"the {name} run: DCD {frames.shape}")
        rows = [r["ms_per_step"] for r in _metrics(metrics)]
        out[name] = dict(line=line[0], rows=rows, steady=sum(rows[1:]) / len(rows[1:]), wall=wall)
    return out


def writer_runs_alone(torch, root):
    """Phase 18(c) under --runtime-only: phase 9b's flexible-water box built
    again (from_pdb), its step captured, then writer_runs."""
    from ai2bmd_torch.md.simulation import SimulationConfig
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.simulators import ProteinSimulation

    sim_cfg = SimulationConfig(timestep_fs=SOLV_DT_FS, preeq_steps=0, record_per_steps=RECORD)
    ps = ProteinSimulation.from_pdb(SOLVATED, log_dir=os.path.join(root, "solvated"),
                                    model_cfg=ViSNetConfig(), sim_cfg=sim_cfg)
    state = ps.sim.advance(ps.sim.initial_state(ps.prot.positions), 1)
    return writer_runs(torch, ps.sim, state, root)


def run_runtime(torch, card, root, solv=None):
    """Phase 18: the native trajectory writer: (a) the build, (b) the box's
    frames through both writers, (c) phase 9c's CLI lines (``solv``: phase
    9's results; None alone) and the solvated Simulator's ms/step through
    each writer (phase 9b's run, or built here alone)."""
    t_phase = time.perf_counter()
    out = dict(build=runtime_build(), frames=runtime_frames(root, card))
    if solv is None:
        print("  (c) phase 9c's CLI runs: not run alone (the whole script holds their lines)")
        out["writers"] = writer_runs_alone(torch, root)
    else:
        for name, line in solv["cli_writer"].items():
            print(f"  (c) phase 9c's CLI run {name}: {line!r}")
        out["writers"] = solv["flex"]["writers"]
    w = out["writers"]
    for name, r in w.items():
        print(f"  (c) the solvated Simulator.run ({WRITER_STEPS} steps of 17,882 atoms, a record "
              f"every {RECORD}), {r['line']!r}: metrics ms/step {[round(x, 3) for x in r['rows']]}"
              f", steady {r['steady']:.3f}, {r['wall']:.3f} ms/step over the run with its close")
    print(f"  (c) steady ms/step native {w['native']['steady']:.3f} against Python writers "
          f"{w['python']['steady']:.3f} in one call; phase 18 took "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# Phase 19: past 1,024 channels (the edge and full-layer kernels at every H)
# ---------------------------------------------------------------------------

# (a): 8 heads of 133 channels (H % 32 != 0, the padded route), of 160, 16
# of 128 and of 256, at 2 x 24 and 1 x 176 (from PAST_LONE on at 2 x 24
# alone); --past-1024-only adds PAST_ALONE_CASES (32 heads of 256, ~13 s);
# the bfloat16 storage and the highest / default libraries at PAST_BF16
# and PAST_MODES, 2 x 24
PAST_CASES = ((1064, 8), (1280, 8), (2048, 16), (4096, 16))
PAST_ALONE_CASES = ((8192, 32),)
PAST_SHAPES = ((2, 24), (1, 176))
PAST_LONE = 4096
PAST_BF16 = ((1280, 8), (2048, 16))
PAST_MODES = ((1280, 8),)
# (b): the wide kernels' resources at these widths (8,192: sizes only)
PAST_OCC = ((1280, 8), (2048, 16), (4096, 16), (8192, 32))
# (c) the timed case and (d)-(e) the slice's model: 9 x 1,280, 8 heads of 160
PAST_H, PAST_NH = 1280, 8
PAST_TIMED = (4, 40)
# (d): the CPU float64 reference holds a 3 x 1,280 model of the same seed
# (9 layers would take about a minute on the card's host: 9 x 512's took
# ~10 s, and the products grow as H^2)
PAST_REF_LAYERS = 3
# (d): eager steps before and in the timed window, and timed replays, of
# the K1-K3 drive (phase 4's 5 and 20: a step takes ~0.35 s here), and of
# the K5/K6 drive, which runs the same weights again
PAST_WARM, PAST_TIMED_STEPS = 2, 8
PAST_FUSED_WARM, PAST_FUSED_TIMED = 1, 4
PAST_CLI_STEPS, PAST_CLI_RECORD = 10, 5
SMEM_MAX = 232448              # the most shared memory one block may take (csrc/common.cuh)


def past_layer_weights(torch, FL, h, nh, dev, seed):
    """The fused-layer weights {last: tuple} of one ViSNet layer of width h
    with nh heads, drawn on the card (xavier-uniform weights as
    init_params draws them, small random biases and norms; seed ``seed``):
    init_params on the host takes ~10 s at 4,096 channels.  The last
    layer's tuple has zero W_t, W_src, W_f and b_f (FL.layer_weights)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = lambda n_in, n_out: ((torch.rand((n_in, n_out), generator=gen, device=dev) * 2 - 1)
                             * math.sqrt(6.0 / (n_in + n_out)))
    r = lambda *s, sc=0.1: torch.randn(s, generator=gen, device=dev) * sc
    lin = lambda n_in, n_out: {"w": u(n_in, n_out), "b": r(n_out)}
    lp = {"layernorm": {"scale": 1 + r(h), "bias": r(h)}, "vec_layernorm": {"weight": 1 + r(h)},
          "vec_proj": {"w": u(h, 3 * h)}, "q_proj": lin(h, h), "k_proj": lin(h, h),
          "v_proj": lin(h, h), "dk_proj": lin(h, h), "dv_proj": lin(h, h),
          "s_proj": lin(h, 2 * h), "o_proj": lin(h, 3 * h), "w_trg_proj": {"w": u(h, h)},
          "w_src_proj": {"w": u(h, h)}, "f_proj": lin(h, h)}
    return {last: [t.contiguous() for t in FL.layer_weights(lp, h, nh, last)]
            for last in (False, True)}


def check_past_modes(torch, dev, out):
    """Phase 19(a), modes: K1 (update, store), K2, K3, K7, K8 and K5/K6 (both
    ``last``) at PAST_MODES, 2 x 24, from the highest and default libraries,
    held as phase 14 holds its cases (highest within EDGE_TOL of its plain
    model, default by default_misses), bitwise repeats, every launch from
    the mode's library."""
    from concurrent.futures import ThreadPoolExecutor

    from ai2bmd_torch.ops import _build, reset_launches
    from ai2bmd_torch.ops import tf32x3 as T
    from ai2bmd_torch.ops import vislayer as FL
    from ai2bmd_torch.ops import vismp as K

    with ThreadPoolExecutor(2) as pool:   # built by phase 14 in the default run
        list(pool.map(_build.build, ("highest", "default")))
    gen = torch.Generator().manual_seed(23)
    B, A = PAST_SHAPES[0]
    for h, nh in PAST_MODES:
        ws = past_layer_weights(torch, FL, h, nh, dev, 23)
        tag = f"B={B} A={A} H={h} nh={nh}"
        set_mm_mode("b3")
        c = edge_case(torch, K, gen, B, A, dev, h, nh)
        la = layer_inputs(torch, gen, B, A, dev, h)
        for mode in ("highest", "default"):
            set_mm_mode(mode)
            reset_launches()
            mm, line = T.plain_mm(mode), []
            for name, label, run, plain, _, _ in precision_specs(torch, K, FL, c, la, ws, B, A,
                                                                  h, nh):
                if label.startswith("edge_fwd") and label != MAIN_VARIANT["edge_fwd"]:
                    continue
                cell = f"{label} {tag} @{mode}"
                if mode == "default":
                    misses, err, share = default_misses(cell, run(), plain(mm),
                                                        plain(T.mm_highest_plain))
                    need(not misses, f"{cell}: " + "; ".join(misses))
                else:
                    err, share = quiet_compare(cell, run(), plain(mm), EDGE_TOL)
                a, b = run(), run()
                need(all((x is None and y is None) or bool(torch.equal(x, y))
                         for x, y in zip(a, b)), f"{cell}: two runs differ")
                del a, b
                res = out.setdefault(mode, {}).setdefault(name, {"max_abs_err": 0.0})
                res["max_abs_err"] = max(res["max_abs_err"], err)
                line.append(f"{label} {err:.1e} ({share:.3f})")
            only_mode(mode, tag)
            share_of = ("the rounding's difference beyond EDGE_TOL" if mode == "default"
                        else "the EDGE_TOL bound")
            print(f"  {tag} @{mode} (max|d| against its plain model; share of {share_of}): "
                  + "; ".join(line))
        del c, la, ws
        torch.cuda.empty_cache()
    set_mm_mode("b3")


def check_past_kernels(torch, dev, before_timed=None, cases=PAST_CASES):
    """Phase 19(a)-(c): K1 (four flag pairs), K2, K3, K7, K8, K5 and K6 (both
    ``last``) at ``cases`` x PAST_SHAPES (from PAST_LONE on at 2 x 24
    alone) and at
    PAST_TIMED for (PAST_H, PAST_NH), against their plain versions within
    EDGE_TOL, bitwise repeats, K7/K8 against K2/K3 on K1's stash and K6's
    a_ij against K5's (check_wide_case, check_layer_case); the bfloat16
    storage at PAST_BF16 (check_mixed_kernels) and the highest / default
    libraries at PAST_MODES (check_past_modes); the wide kernels' resources
    at PAST_OCC from the launchers' own sizes, none past SMEM_MAX; then
    (``before_timed()`` first, when given: the card to itself) the
    PAST_TIMED case, each kernel's device ms beside its plain version's,
    its bound and share.  Returns {kernel: figures}, "bf16", "modes" and
    "occupancy"."""
    from ai2bmd_torch.ops import vislayer as FL
    from ai2bmd_torch.ops import vismp as K

    gen = torch.Generator().manual_seed(19)
    out = {}

    def run_case(h, nh, B, A, ws, timed=False):
        t0 = time.perf_counter()
        per = {}
        c = edge_case(torch, K, gen, B, A, dev, h, nh)
        check_wide_case(torch, K, c, B, A, h, nh, per, timed)
        del c
        torch.cuda.empty_cache()
        check_layer_case(torch, FL, ws, layer_inputs(torch, gen, B, A, dev, h), B, A, h, nh,
                         per, timed)
        for name, res in per.items():
            o = out.setdefault(name, {"max_abs_err": 0.0, "cases": {}})
            o["max_abs_err"] = max(o["max_abs_err"], res["max_abs_err"])
            o["cases"][f"H={h} nh={nh} B={B} A={A}"] = res["max_abs_err"]
            if "timed" in res:
                o["timed"] = res["timed"]
        torch.cuda.empty_cache()
        print(f"  H={h} nh={nh} B={B} A={A}: {time.perf_counter() - t0:.1f} s")

    weights = lambda h, nh: {last: FL.padded_layer_weights(w, h) for last, w in
                             past_layer_weights(torch, FL, h, nh, dev, 19).items()}
    for h, nh in cases:
        need(not K.narrow_shapes(h, nh) and K.layer_shapes(h, nh, S) and h > 1024,
             f"H={h}, nh={nh}: not a wide shape past 1,024")
        ws = weights(h, nh)
        for B, A in PAST_SHAPES if h < PAST_LONE else PAST_SHAPES[:1]:
            run_case(h, nh, B, A, ws)
        del ws
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print(f"  (a) the bfloat16 storage at {PAST_BF16}, B x A = {PAST_SHAPES[0]}")
    bf16 = {n: {"max_abs_err": 0.0} for n in MIXED_KERNELS}
    check_mixed_kernels(torch, dev, bf16, [(*PAST_SHAPES[0], h, nh) for h, nh in PAST_BF16])
    print(f"  {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"  (a) the highest and default libraries at {PAST_MODES}, B x A = {PAST_SHAPES[0]}")
    modes = {}
    check_past_modes(torch, dev, modes)
    print(f"  {time.perf_counter() - t0:.1f} s")
    print(f"  (b) the wide kernels' resources at {PAST_OCC} (launchers' sizes; nothing launched "
          f"at 8,192)")
    occ = {"edge": wide_occupancy(torch, PAST_OCC), **layer_wide_occupancy(torch, PAST_OCC)}
    worst = max(r["smem_bytes"] for part in occ.values() for rows in part.values()
                for r in rows.values())
    print(f"  the largest block's shared memory at any of these widths: {worst} B (SMEM_MAX "
          f"{SMEM_MAX})")
    need(worst <= SMEM_MAX, f"a wide block takes {worst} B of shared memory, past {SMEM_MAX}")
    if before_timed is not None:
        before_timed()
    run_case(PAST_H, PAST_NH, *PAST_TIMED, weights(PAST_H, PAST_NH), timed=True)
    print(f"  (c) at H={PAST_H}, {PAST_NH} heads, B x A = {PAST_TIMED} (device ms, plain, "
          f"bound, share):")
    for name, o in out.items():
        t = o["timed"]
        print(f"    {name:16s} {fmt_ms(t['device_ms'])} (plain {fmt_ms(t['plain_device_ms'])}), "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), {100 * t['share']:.1f}%; max "
              f"abs err over the cases {o['max_abs_err']:.2e}")
    for name, label in (("edge_fwd", "K1 update store"), ("edge_bwd_msg", "K2"),
                        ("edge_bwd_upd", "K3 centre"), ("edge_bwd_msg_rc", "K7"),
                        ("edge_bwd_upd_rc", "K8 centre")):
        out[name]["occupancy"] = {w: rows[label] for w, rows in occ["edge"].items()}
    for name in ("vislayer_fwd", "vislayer_bwd"):
        out[name]["occupancy"] = occ[name]
    out.update(bf16=bf16, modes=modes, occupancy=occ, smem_max_seen=worst)
    return out


def run_past_slice(torch, dev, prot, card):
    """Phase 19(d): Chignolin at 9 x PAST_H with PAST_NH heads (random,
    seed 0) through K1-K3 and K4, then the same weights with
    AI2BMD_FUSED_LAYER=1 through K5/K6, each driven as phase 4 (graphed,
    ms/step, kernels a step, busy share, the capture's peak memory), one
    warm evaluation's launches equal to phase 4's per batch; one evaluation
    with remat (K1 without a stash, K7/K8) against the step 0; step 0
    through K5/K6 against K1-K3's.  Returns the figures."""
    from ai2bmd_torch.ops import LAUNCHES, reset_launches

    res = {}
    label = f"9 x {PAST_H}, {PAST_NH} heads of {PAST_H // PAST_NH}"
    print(f"  (d) Chignolin, ViSNet {label}, through the wide K1-K3")
    pot, _, _ = wide_potential(torch, dev, prot, h=PAST_H, nh=PAST_NH)
    need(not pot.cfg.fused_layer and not pot.cfg.plain_edge_core and not pot.cfg.remat,
         f"the model resolved to {pot.cfg}")
    launches, ms_step, P, aux0, aux1, e0, f0, graphed = drive(
        torch, dev, prot, pot, card, WIDE_KERNELS, PAST_WARM, PAST_TIMED_STEPS)
    for name in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "cap_grad"):
        need(launches[name] > 0, f"kernel {name} was not launched on the slice")
    for name in ("vislayer_fwd", "vislayer_bwd", "edge_bwd_msg_rc", "edge_bwd_upd_rc",
                 "tf32x3_mm"):
        need(launches[name] == 0, f"{name} ran on the slice's K1-K3 path")
    torch.cuda.synchronize()
    reset_launches()
    pot.stateful_energy_forces(P, aux1)
    torch.cuda.synchronize()
    batches = len(pot.rt.dip_buckets) + 1
    one = {n: LAUNCHES[n] for n in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "cap_grad")}
    want = {"edge_fwd": N_LAYERS * batches, "edge_bwd_msg": N_LAYERS * batches,
            "edge_bwd_upd": (N_LAYERS - 1) * batches, "cap_grad": 1}
    print(f"  one warm evaluation launches {one} (phase 4's per evaluation: {want})")
    need(one == want, f"the slice launches {one} an evaluation, not {want}")
    res["edge"] = dict(launches=launches, per_eval=one, ms_step_eager=ms_step, graphed=graphed)

    print("  (d) the same weights with remat=True: one evaluation through K1 without its stash "
          "and K7/K8")
    pot_rc, _, _ = wide_potential(torch, dev, prot, remat=True, h=PAST_H, nh=PAST_NH)
    torch.cuda.synchronize()
    reset_launches()
    e_rc, f_rc, _ = pot_rc.stateful_energy_forces(P, aux0)
    torch.cuda.synchronize()
    rc_launches = {n: v for n, v in LAUNCHES.items() if v}
    dF_rc = float((f_rc - f0).abs().max())
    print(f"  launches {rc_launches}; forces vs the slice's step 0: max|dF| {dF_rc:.3e} eV/A, "
          f"|dE| {abs(float(e_rc) - float(e0)):.3e} eV (limit {FORCE_LIMIT})")
    need(LAUNCHES["edge_bwd_msg_rc"] == N_LAYERS * batches
         and LAUNCHES["edge_bwd_upd_rc"] == (N_LAYERS - 1) * batches
         and LAUNCHES["edge_fwd"] == N_LAYERS * batches
         and LAUNCHES["edge_bwd_msg"] == 0 and LAUNCHES["edge_bwd_upd"] == 0,
         f"the remat evaluation launched {rc_launches}")
    need(dF_rc <= FORCE_LIMIT, f"remat forces differ from the step 0 by {dF_rc:.3e}")
    res.update(remat_launches=rc_launches, remat_max_dF=dF_rc)
    del pot_rc, pot
    torch.cuda.empty_cache()

    print(f"  (d) the same weights with AI2BMD_FUSED_LAYER=1: the wide K5/K6")
    pot_f, _, _ = wide_potential(torch, dev, prot, h=PAST_H, nh=PAST_NH, fused=True)
    launches_f, ms_f, _, _, aux1_f, _, _, graphed_f = drive(
        torch, dev, prot, pot_f, card, LAYER_WIDE_KERNELS, PAST_FUSED_WARM, PAST_FUSED_TIMED)
    for name in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "edge_bwd_msg_rc",
                 "edge_bwd_upd_rc", "tf32x3_mm"):
        need(launches_f[name] == 0, f"{name} ran on the slice's full-layer path")
    torch.cuda.synchronize()
    reset_launches()
    pot_f.stateful_energy_forces(P, aux1_f)
    torch.cuda.synchronize()
    one_f = layer_launches(LAUNCHES)
    want_f = dict({n: 0 for n in one_f}, vislayer_fwd=N_LAYERS * batches,
                  vislayer_bwd=N_LAYERS * batches, cap_grad=1)
    print(f"  one warm evaluation launches {one_f}")
    need(one_f == want_f, f"the full-layer slice launches {one_f} an evaluation, not {want_f}")
    e0_f, f0_f, _ = pot_f.stateful_energy_forces(P, aux0)   # K1-K3's step 0, its caps
    dF_paths = float((f0_f - f0).abs().max())
    print(f"  step 0 through K5/K6 against K1-K3's (9 layers, the card): max|dF| {dF_paths:.3e} "
          f"eV/A, |dE| {abs(float(e0_f) - float(e0)):.3e} eV (limit {FORCE_LIMIT})")
    need(dF_paths <= FORCE_LIMIT, f"the two paths' step 0 differ by {dF_paths:.3e}")
    res["fused"] = dict(launches=launches_f, per_eval=one_f, ms_step_eager=ms_f,
                        graphed=graphed_f, max_dF_vs_edge=dF_paths)
    del pot_f
    torch.cuda.empty_cache()

    return res


def start_past_reference(torch, dev, prot):
    """Phase 19(d), step 0: a PAST_REF_LAYERS x PAST_H model of the same seed
    (PAST_NH heads) through K1-K3 and through K5/K6 on the card, from cold
    caps of its own, and its float64 run on the CPU started in a thread,
    which runs beside the slice's drives (the card does their work).
    Returns what finish_past_reference needs."""
    from ai2bmd_torch.models.visnet import ViSNet
    from ai2bmd_torch.potentials import FragmentPotential

    print(f"  (d) step 0 against the CPU in float64: {PAST_REF_LAYERS} x {PAST_H}, {PAST_NH} "
          f"heads (seed 0), through each path; the float64 run in a thread beside the drives")
    P = torch.as_tensor(prot.positions, dtype=torch.float32, device=dev)
    card = {}
    for route, fused in (("K1-K3", False), ("K5/K6", True)):
        pot3, cfg3, params3 = wide_potential(torch, dev, prot, h=PAST_H, nh=PAST_NH,
                                             layers=PAST_REF_LAYERS, fused=fused)
        if not card:
            aux0 = pot3.init_cap_delta(P)
        card[route] = pot3.stateful_energy_forces(P, aux0)[:2]
        del pot3
    cpu = torch.device("cpu")
    P64, aux64 = P.to(cpu, torch.float64), aux0.to(cpu, torch.float64)

    def reference():
        t0 = time.perf_counter()
        pot64 = FragmentPotential.build(prot, ViSNet(cfg3, params3).to(torch.float64), cfg3,
                                        longrange="mm", device="cpu")
        return pot64.stateful_energy_forces(P64, aux64)[:2], time.perf_counter() - t0

    return in_thread(reference), card


def finish_past_reference(torch, started):
    """Phase 19(d), step 0: each path's forces within FORCE_LIMIT of the
    float64 run.  Returns ({path: max|dF|}, the reference's seconds)."""
    wait, card = started
    ((e_ref, f_ref), secs), waited = wait()
    step0 = {}
    for route, (e3, f3) in card.items():
        dF = float((f3.cpu().double() - f_ref).abs().max())
        step0[route] = dF
        print(f"  {route}: |dE| {abs(float(e3) - float(e_ref)):.3e} eV, max|dF| {dF:.3e} eV/A "
              f"(limit {FORCE_LIMIT}); max|F| {float(f_ref.abs().max()):.3f} eV/A")
        need(dF <= FORCE_LIMIT, f"{route}: step-0 forces differ from float64 by {dF:.3e}")
    print(f"  the float64 reference took {secs:.1f} s (waited {waited:.1f} s for it)")
    return step0, secs


def save_past_npz(torch, root):
    """Phase 19(e)'s checkpoint: the slice's weights (ViSNet 9 x PAST_H,
    PAST_NH heads, seed 0, as wide_potential makes them), made and written
    by save_converted (~1.2 GB compressed on the host) in a thread of its
    own; the whole script starts it before phase 16, so that the host does
    it beside the card's work.  Returns (its waiter, path)."""
    from ai2bmd_torch.models.checkpoint import save_converted
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNetConfig

    os.makedirs(root, exist_ok=True)
    npz = os.path.join(root, f"visnet-chig-9x{PAST_H}-{PAST_NH}h.npz")

    def save():
        cfg = ViSNetConfig(hidden_channels=PAST_H, num_heads=PAST_NH)
        save_converted(npz, init_params(cfg, torch.Generator().manual_seed(0)), cfg)

    return in_thread(save), npz


def start_past_cli(root, saving):
    """Phase 19(e): the CLI on the slice's .npz (save_converted, written by
    ``saving``, save_past_npz's waiter and path), PAST_CLI_STEPS steps at
    USER_DT_FS, a record every PAST_CLI_RECORD, started in the background
    (it runs beside (a)'s untimed checks).  Returns (process, log dir, start
    time)."""
    wait, npz = saving
    _, waited = wait()
    print(f"  waited {waited:.1f} s for the .npz ({os.path.getsize(npz) / 2**20:.0f} MiB)")
    d = os.path.join(root, "past_1024")
    proc = _cli_start(_cli_cmd(
        d, "--ckpt-path", npz, "--preeq-steps", "0", "--sim-steps", str(PAST_CLI_STEPS),
        "--record-per-steps", str(PAST_CLI_RECORD), "--timestep", str(USER_DT_FS)))
    return proc, d, time.perf_counter()


def finish_past_cli(started):
    """Phase 19(e), its end: exit 0, the model line naming the wide K1-K3."""
    proc, d, t0 = started
    txt = _cli_wait("past 1,024", proc)
    need("Simulation finished!" in txt, "the CLI run past 1,024 did not finish")
    rows = _metrics(os.path.join(d, "chig-metrics.csv"))
    line = cli_model_line(txt, "edge-core kernels K1-K3 (wide instantiations: K1, K2, K3)")
    need(f"ViSNet {N_LAYERS} x {PAST_H}, {PAST_NH} heads:" in line, f"the CLI ran {line!r}")
    print(f"  (e) exit 0 in {time.perf_counter() - t0:.1f} s, {PAST_CLI_STEPS} steps at "
          f"{USER_DT_FS} fs; metrics ms/step {[r['ms_per_step'] for r in rows]} (beside (a)'s "
          f"checks); {line!r}")
    return dict(line=line, ms_per_step=[r["ms_per_step"] for r in rows])


def run_past_1024(torch, dev, prot, card, root, saving=None, cases=PAST_CASES):
    """Phase 19: (e) the CLI on the slice's weights (``saving``:
    save_past_npz's, started here when None), started first
    (start_past_cli) and run beside (a)-(b) (check_past_kernels), its end
    awaited (finish_past_cli) before (c), the timed case; (d) the 9 x 1,280
    slice (run_past_slice) and the step 0 of a 3 x 1,280 model
    (start_past_reference, its float64 run beside the drives,
    finish_past_reference).  Returns its figures."""
    t_phase = time.perf_counter()
    res = {}
    print(f"  (e) python -m ai2bmd_torch --ckpt-path on the slice's weights, in the background")
    started = start_past_cli(root, saving or save_past_npz(torch, root))

    def finish_cli():
        t0 = time.perf_counter()
        res["cli"] = finish_past_cli(started)
        res["e_wait_s"] = time.perf_counter() - t0

    print(f"  (a) K1 (four flag pairs), K2, K3, K7, K8, K5 and K6 at (H, heads) {cases} "
          f"against their plain versions")
    res["kernels"] = check_past_kernels(torch, dev, before_timed=finish_cli, cases=cases)
    res["abc_s"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    reference = start_past_reference(torch, dev, prot)
    sl = run_past_slice(torch, dev, prot, card)
    sl["step0_max_dF"], sl["ref_s"] = finish_past_reference(torch, reference)
    res["d_s"] = time.perf_counter() - t0
    res["slice"] = sl
    res["phase_s"] = time.perf_counter() - t_phase
    g, gf = sl["edge"]["graphed"], sl["fused"]["graphed"]
    print(f"  9 x {PAST_H}, {PAST_NH} heads: graphed {g['ms_step']:.3f} ms/step (events "
          f"{g['ms_events']:.3f}, {g['kernels_per_step']:.0f} kernels a step, "
          f"{100 * g['busy_share']:.1f}% busy, capture peak {g['peak_mib']:.1f} MiB) through "
          f"K1-K3; {gf['ms_step']:.3f} (events {gf['ms_events']:.3f}, "
          f"{gf['kernels_per_step']:.0f} kernels, {100 * gf['busy_share']:.1f}% busy, "
          f"{gf['peak_mib']:.1f} MiB) through K5/K6; step 0 ({PAST_REF_LAYERS} layers) max|dF| "
          + ", ".join(f"{k} {v:.3e}" for k, v in sl["step0_max_dF"].items())
          + f"; (a)-(c) took {res['abc_s']:.1f} s (waiting {res['e_wait_s']:.1f} s of it for "
          f"the CLI), (d) {res['d_s']:.1f} s, phase 19 {res['phase_s']:.1f} s ({card})")
    return res


def past_entry(p19, name):
    """A kernel's figures of phase 19 for the kernels line: its largest error
    over the cases past 1,024 channels, the timed case's ms, bound and
    share, its resources by width, its launches on the slice."""
    k = p19["kernels"]
    if name in MIXED_KERNELS:
        return dict(max_abs_err=k["bf16"][name]["max_abs_err"], cases=PAST_BF16)
    res = k[name]
    sl = p19["slice"]
    return dict(max_abs_err=res["max_abs_err"], timed=res.get("timed"),
                occupancy=res["occupancy"],
                modes={m: v[name]["max_abs_err"] for m, v in k["modes"].items() if name in v},
                slice_launches_per_eval=sl["fused" if name in LAYER_PATH else "edge"]
                ["per_eval"].get(name, 0),
                remat_launches_per_eval=sl["remat_launches"].get(name, 0))


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
    ap.add_argument("--mesh-only", action="store_true",
                    help="after the build, run only phase 13 (the dp x mp mesh: ShardedPotential, "
                         "EnsembleSimulation and ReplicaEnsemble in a world of one NCCL rank and "
                         "of two gloo ranks sharing the card), without the final line")
    ap.add_argument("--precision-only", action="store_true",
                    help="after the build, run only phase 14 (the kernels, the lone step and the "
                         "CLI under each products' mode and --matmul-precision), without the "
                         "final line")
    ap.add_argument("--wide-only", action="store_true",
                    help="after the build, run only phase 15 (the edge kernels at every head and "
                         "hidden width, and Chignolin at 3 x 512 with 4 heads through them), "
                         "without the final line")
    ap.add_argument("--layer-wide-only", action="store_true",
                    help="after the build, run only phase 16 (the full-layer kernels at every head "
                         "and hidden width, Chignolin at 3 x 512 with 4 heads through them, and a "
                         "molecule of 1,112 slots), without the final line")
    ap.add_argument("--mixed-only", action="store_true",
                    help="after the build, run only phase 17 (the mixed-precision mode: the "
                         "bfloat16 edge kernels against their plain versions, in each products' "
                         "mode, the lone Chignolin step and two whole molecules with "
                         "edge_dtype=bfloat16, the float32 kernels' hashes), without the final "
                         "line")
    ap.add_argument("--past-1024-only", action="store_true",
                    help="after the build, run only phase 19 (past 1,024 channels: the edge and "
                         "full-layer kernels at H = 1,064-8,192 against their plain versions "
                         "(8,192 only here), "
                         "their resources to 8,192, Chignolin at 9 x 1,280 with 8 heads through "
                         "K1-K3 and K5/K6, the CLI on it), without the final line")
    ap.add_argument("--runtime-only", action="store_true",
                    help="after the build, run only phase 18 (the native trajectory writer: its "
                         "g++ build, the solvated box's frames through it and through the Python "
                         "writers, the solvated Simulator through each), without the final line")
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
    if "units" in _build.BUILD_INFO:
        print("  each source's nvcc ended after (s): " + ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(_build.BUILD_INFO["units"].items(),
                                               key=lambda kv: -kv[1])))
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
    if args.past_1024_only:
        shutil.rmtree(root, ignore_errors=True)
        print("== 19. past 1,024 channels (alone)")
        run_past_1024(torch, dev, load_protein(example_pdb("chig")), card, root,
                      cases=PAST_CASES + PAST_ALONE_CASES)
        no_plain("19")
        return
    if args.runtime_only:
        shutil.rmtree(root, ignore_errors=True)
        print("== 18. the native trajectory writer (alone)")
        run_runtime(torch, card, root)
        return
    if args.mixed_only:
        print("== 17. the mixed-precision mode (alone)")
        run_mixed(torch, dev, load_protein(example_pdb("chig")), card)
        return
    if args.layer_wide_only:
        shutil.rmtree(root, ignore_errors=True)
        print("== 16. the full-layer kernels at every width, one molecule past 1,024 slots (alone)")
        run_layer_widths(torch, dev, load_protein(example_pdb("chig")), card, root)
        return
    if args.wide_only:
        shutil.rmtree(root, ignore_errors=True)
        print("== 15. every head and hidden width through the edge kernels (alone)")
        run_widths(torch, dev, load_protein(example_pdb("chig")), card, root)
        return
    if args.precision_only:
        shutil.rmtree(root, ignore_errors=True)
        print("== 14. the products' modes and --matmul-precision (alone)")
        run_precision(torch, dev, load_protein(example_pdb("chig")), card, root)
        return
    if args.mesh_only:
        shutil.rmtree(root, ignore_errors=True)
        print("== 13. the mesh (alone)")
        run_mesh(torch, dev, load_protein(example_pdb("chig")), card, root)
        return
    if args.amoeba_only:
        shutil.rmtree(root, ignore_errors=True)
        print("== 12. AMOEBA preprocessing and pure-AMOEBA MD (alone)")
        run_amoeba(torch, dev, card, root)
        return
    if args.polarizable_only:
        shutil.rmtree(root, ignore_errors=True)
        print("== 11. the polarizable routes (alone)")
        run_polarizable(torch, dev, card, root, {}, amoeba_cli=True)
        return
    if args.solvated_only:
        shutil.rmtree(root, ignore_errors=True)
        print("== 9. the solvated slice (alone)")
        solv = run_solvated(torch, dev, load_protein(example_pdb("chig")), card, root,
                            float("nan"))
        print("== 10. preprocessing and solvated replicas")
        run_preprocessing_and_replicas(torch, dev, card, root, solv["flex"])
        return

    phase("== 3. kernels against their plain versions")
    results = {n: {"max_abs_err": 0.0} for n in KERNELS}
    check_tf32x3(torch, dev)
    check_layer_kernels(torch, dev, results)
    check_edge_kernels(torch, dev, results)
    prot = load_protein(example_pdb("chig"))
    check_cap_kernel(torch, dev, prot, results)
    whole = {A: {} for _, A in WHOLE_SHAPES}
    check_whole_layer_kernels(torch, dev, whole)
    check_whole_molecule_kernels(torch, dev, whole)
    check_head_widths(torch, dev, results)
    report_occupancy(torch, results, whole)
    cublas_yardstick(torch, dev, results)
    if args.stop_after == 3:
        return
    prebuild = prebuild_modes()

    phase("== 4. the slice: Chignolin, ViSNet 9 x 256, fragment MD, edge-core kernels K1-K3")
    launches, ms_step, graphed, ref, pending = run_slice(torch, dev, prot, card)
    no_plain("4")
    phase("== 4b. the same slice through the full-layer kernels K5/K6")
    launches_fl, ms_step_fl, graphed_fl, step0_fl = run_fused_slice(torch, dev, prot, card, ref)
    no_plain("4b")
    phase("== 5. the replica ensemble: 64 Chignolin replicas, 9 x 256, remat=True (K1, K7, K8)")
    launches_ens = run_ensemble(torch, dev, prot, card, ref)
    no_plain("5")
    finish_slice(torch, ref, pending, step0_fl)    # phase 4's CPU float64 run, beside 4b and 5
    phase("== 6. the user-facing path: ProteinSimulation and the CLI (python -m ai2bmd_torch)")
    shutil.rmtree(root, ignore_errors=True)
    run_user_library(torch, dev, root, ref)
    cli_ms = run_user_cli(torch, root, graphed["ms_step"], card)
    no_plain("6")
    phase("== 7. whole-molecule mode: converted checkpoint, Chignolin (A = 176) and abd "
          "(A = 752) as one molecule, 9 x 256")
    wm = run_whole_molecule(torch, dev, prot, card, root)
    no_plain("7")
    phase("== 8. the repaired faults: the tiny preset on the card, warm_caps=False, "
          "--no-solvent on a solvated input")
    cold_ms = run_faults(torch, dev, card, root, graphed["ms_step"])
    no_plain("8")
    phase("== 9. the solvated slice: PME in fragment mode, QM/MM of the solvated Chignolin box "
          "(17,882 atoms) at 9 x 256, the CLI on it, 64-channel heads and the plain route")
    solv = run_solvated(torch, dev, prot, card, root, graphed["ms_step"])
    phase("== 10. preprocessing (solvate, minimize, heat, NVT, NPT) of Chignolin on the card, the "
          "CLI's --solvent route, SolvatedReplicaEnsemble (4 replicas of the box, 9 x 256), the "
          "CLI's --replicas route on the box")
    p10 = run_preprocessing_and_replicas(torch, dev, card, root, solv["flex"])
    phase("== 11. the polarizable routes on the solvated box at 9 x 256: the nl pair route with "
          "its list built inside the captured step, the induced-dipole hybrid, AMOEBA QM/MM; the "
          "CLI's --polarizable-mm")
    p11 = run_polarizable(torch, dev, card, root, solv["flex"])
    phase("== 12. AMOEBA preprocessing of Chignolin (Preprocessor(method=\"AMOEBA\"), 3,615 "
          "atoms) and pure-AMOEBA MD on the box: float32 vs float64, captured descent cycles vs "
          "eager, GraphedLangevin steps, the CLI's --preprocess-method AMOEBA")
    from ai2bmd_torch.ops import LAUNCHES, reset_launches

    reset_launches()
    p12 = run_amoeba(torch, dev, card, root)
    amoeba_launches = dict(LAUNCHES)
    no_plain("12")
    phase("== 13. the mesh: ShardedPotential, EnsembleSimulation and ReplicaEnsemble over dp x "
          "mp meshes of ranks (Chignolin, 9 x 256): an NCCL world of one rank, a gloo world of "
          "two ranks sharing the card")
    mesh_launches = run_mesh(torch, dev, prot, card, root)
    no_plain("13")
    phase("== 14. the products' modes (AI2BMD_KERNEL_MM_PRECISION b3, highest, default): each "
          "kernel against its mode's plain model (the lone graphed step in each mode: "
          "--precision-only); the CLI's --matmul-precision")
    p14 = run_precision(torch, dev, prot, card, root, ref, prebuild, lone_step=False)
    no_plain("14")
    phase(f"== 15. every head and hidden width through the edge kernels: K1-K3, K7, K8 at heads "
          f"of 24 to 1024 channels and H = 40 to 1024 against their plain versions; Chignolin at "
          f"{WIDE_LAYERS} x {WIDE_H} with {WIDE_NH} heads (graphed, remat, the CLI, "
          f"AI2BMD_FUSED_LAYER=1)")
    p15 = run_widths(torch, dev, prot, card, root)
    no_plain("15")
    phase(f"== 16. the full-layer kernels at every width and one molecule past 1,024 slots: K5/K6 at "
          f"heads of 8 to 256 channels and H = 40 to 1024 against their plain versions; Chignolin "
          f"at {WIDE_LAYERS} x {WIDE_H} with {WIDE_NH} heads through them (graphed, the CLI), "
          f"2 x {PAD_H}; "
          f"ACE-(ALA){POLY_RES}-NME (1,112 slots) through every kernel and both routes")
    p19_npz = save_past_npz(torch, root)   # phase 19's checkpoint, written beside 16-18
    p16 = run_layer_widths(torch, dev, prot, card, root, ref15=p15["ref"])
    no_plain("16")
    phase("== 17. the mixed-precision mode (ViSNetConfig.edge_dtype=torch.bfloat16): the "
          "bfloat16 instantiations of K1-K3, K7, K8 against their plain versions (narrow and "
          "wide, in each products' mode); the lone Chignolin step and two whole molecules in the "
          "mode; the float32 kernels' hashes")
    p17 = run_mixed(torch, dev, prot, card, ref, p16["long"]["evals"]["fused"]["peak_gib"])
    no_plain("17")
    phase("== 18. the native trajectory writer (ai2bmd_torch.runtime): its g++ build, 10 frames "
          "of the solvated box through it and through the Python writers, phase 9c's CLI lines, "
          "the solvated Simulator through each writer")
    p18 = run_runtime(torch, card, root, solv)
    no_plain("18")
    phase(f"== 19. past 1,024 channels: K1-K3, K7, K8, K5 and K6 at H = 1,064 to 4,096 (heads of "
          f"128 to 256 channels) against their plain versions, in bfloat16 storage and each "
          f"products' mode; their resources to H = 8,192; Chignolin at 9 x {PAST_H} with "
          f"{PAST_NH} heads through K1-K3 and K5/K6 (graphed, remat, the CLI)")
    p19 = run_past_1024(torch, dev, prot, card, root, p19_npz)
    no_plain("19")
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
    for k in kernels:      # phase 13(b): rank 0's launches a warm evaluation, by mesh
        k["mesh_launches"] = {mesh: warm.get(k["name"], 0) for mesh, warm in mesh_launches.items()}
    for k in kernels:      # phase 14: by products' mode
        if k["name"] != "cap_grad":
            k["precision_modes"] = precision_entry(p14, k["name"])
    for k in kernels:      # phases 15 and 16: the wide instantiations
        if k["name"] in EDGE_NAMES:
            k["wide"] = wide_entry(p15, k["name"])
        elif k["name"] in LAYER_PATH:
            k["wide"] = layer_wide_entry(p16, k["name"])
    for k in kernels:      # phase 16(e): one molecule of 1,112 slots
        if k["name"] in EDGE_NAMES or k["name"] in LAYER_PATH:
            k["slots_1112"] = long_entry(p16, k["name"])
    kernels += [mixed_entry(p17, n) for n in MIXED_KERNELS]   # phase 17: bfloat16 storage
    for k in kernels:      # phase 19: past 1,024 channels
        if k["name"] in EDGE_NAMES or k["name"] in LAYER_PATH or k["name"] in MIXED_KERNELS:
            k["past_1024"] = past_entry(p19, k["name"])
    g17 = p17["step"]["mixed"]
    g19, g19f = p19["slice"]["edge"]["graphed"], p19["slice"]["fused"]["graphed"]
    phase("== 20. results")
    print("  seconds by phase (from its header to the next one's; 1-2, the environment and "
          f"the build, {PHASE_AT[0][1] - T_WALL:.1f}): " + ", ".join(
              f"{name} {b - a:.1f}" for (name, a), (_, b) in zip(PHASE_AT, PHASE_AT[1:])))
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
          f"cycle), AmoebaMD {p12['md_ms']:.3f} ms/step; the wide slice ({WIDE_LAYERS} x {WIDE_H}, "
          f"{WIDE_NH} heads) graphed "
          f"{p15['graphed']['ms_step']:.3f} (events {p15['graphed']['ms_events']:.3f}) K1-K3, "
          f"{p16['slice']['graphed']['ms_step']:.3f} (events "
          f"{p16['slice']['graphed']['ms_events']:.3f}) K5/K6; 1,112 slots an evaluation "
          f"{p16['long']['evals']['remat']['ms']:.3f} (remat), "
          f"{p16['long']['evals']['fused']['ms']:.3f} (K5/K6) ms; the mixed-precision lone "
          f"step graphed {g17['ms_step']:.3f} (events {g17['ms_events']:.3f}) beside float32's "
          f"{graphed['ms_step']:.3f} (events {graphed['ms_events']:.3f}); the box's frame "
          f"through the native writer {p18['frames']['native_ms']:.3f} ms (submit), the Python "
          f"writers {p18['frames']['python_ms']:.3f}; the solvated run's steady ms/step native "
          f"{p18['writers']['native']['steady']:.3f}, Python writers "
          f"{p18['writers']['python']['steady']:.3f}; 9 x {PAST_H}, {PAST_NH} heads graphed "
          f"{g19['ms_step']:.3f} (events {g19['ms_events']:.3f}) K1-K3, {g19f['ms_step']:.3f} "
          f"(events {g19f['ms_events']:.3f}) K5/K6; "
          f"{time.perf_counter() - T_START:.0f} s since start")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
