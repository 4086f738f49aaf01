#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ai2bmd_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero and the final line
is not printed):

  1. environment: torch / CUDA / nvcc / triton versions and the card;
     a machine without a CUDA device stops here
  2. build the kernels from ai2bmd_torch/ops/csrc with nvcc
  3. each kernel (K1 edge_fwd in all four flag pairs, K2 edge_bwd_msg,
     K3 edge_bwd_upd, K4 cap_grad) against its plain PyTorch version on the
     card at the main path's shapes: max abs / relative error against a
     stated tolerance, bitwise repeatability, times in turns (CUDA events
     per call, and device time from a profiler trace)
  4. the slice: Chignolin, production ViSNet (9 x 256, random weights from
     seed 0), FragmentPotential("mm"), cold caps (10 L-BFGS iterations),
     then warm Langevin steps at 1 fs / 300 K; launch counters reset just
     before and read just after; step 0 held against the same port on the
     CPU in float64 through the plain versions (limit 1e-3 eV/A); a
     profiled window of 3 steps gives the device busy share
  5. one JSON line of kernel results, the card's name and power limit, and
     the final JSON line.

Imports no JAX.  The ms/step it prints is a smoke figure, not a benchmark.
"""

import json
import os
import subprocess
import sys
import time

SHAPES = [(2, 24), (4, 32), (4, 40), (9, 16)]   # Chignolin's (B, A) ViSNet batches
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


def device_ms(torch, fn, reps=10):
    """Summed device time of the kernels fn() runs, per call, from a
    torch.profiler (CUPTI) trace; None if the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps if us > 0 else None


def in_turns(torch, kernel, plain, reps=20):
    """Per-call times of the kernel and its plain version, in turns (plain,
    kernel, kernel, plain): CUDA events around a loop of calls, which
    include the host's issue time when it exceeds the device's, and the
    device time alone from a profiler trace.  Returns a dict."""
    p1 = cuda_ms(torch, plain, reps)
    k1 = cuda_ms(torch, kernel, reps)
    k2 = cuda_ms(torch, kernel, reps)
    p2 = cuda_ms(torch, plain, reps)
    out = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "device_ms": device_ms(torch, kernel), "plain_device_ms": device_ms(torch, plain)}
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    print(f"    time per call: kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms "
          f"(events); device: kernel {fmt(out['device_ms'])}, plain "
          f"{fmt(out['plain_device_ms'])}")
    return out


def add_times(res, t):
    for key, val in t.items():
        if val is None or res.get(key, 0.0) is None:
            res[key] = None
        else:
            res[key] = res.get(key, 0.0) + val


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


def edge_inputs(torch, gen, B, A, dev):
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


def check_edge_kernels(torch, dev, results):
    from ai2bmd_torch.ops import vismp as K

    gen = torch.Generator().manual_seed(0)
    fwd_keys = ("x_agg", "vec_agg", "df", "zdkv", "zs", "zf")
    for B, A in SHAPES:
        a = edge_inputs(torch, gen, B, A, dev)
        core = (a["q"], a["k"], a["v"], a["vec"], a["edge"], a["d_sh"], a["dist"], a["adj"],
                a["w_dkv"], a["b_dkv"], a["w_s"], a["b_s"], CUTOFF, NH)
        upd = dict(wt=a["wt"], wsrc=a["wsrc"], w_f=a["w_f"], b_f=a["b_f"])
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
                    add_times(res, in_turns(torch, run,
                                            lambda kw=kw: K.edge_fwd_plain(*core, **kw)))

        _, _, _, zdkv, zs, zf = K.edge_fwd(*core, **upd, store=True)
        g_x = (torch.randn((B, A, H), generator=gen)).to(dev)
        g_va = (torch.randn((B, A, S, H), generator=gen)).to(dev)
        g_df = (torch.randn((B, A, A, H), generator=gen) * a["adj"].cpu()[..., None]).to(dev)
        msg_args = (a["q"], a["k"], a["v"], a["vec"], zdkv, zs, a["d_sh"], a["dist"], a["adj"],
                    a["w_dkv"], a["w_s"], g_x, g_va, CUTOFF, NH)
        name = f"edge_bwd_msg B={B} A={A}"
        print(f"  {name}")
        keys = ("g_q", "g_k", "g_v", "g_vec", "g_edge", "g_d_sh", "g_dist")
        run = lambda: K.edge_bwd_msg(*msg_args)
        res = results["edge_bwd_msg"]
        res["max_abs_err"] = max(res["max_abs_err"], compare(
            name, run(), dict(zip(keys, K.edge_bwd_msg_plain(*msg_args))), EDGE_TOL))
        bitwise(name, run)
        add_times(res, in_turns(torch, run, lambda: K.edge_bwd_msg_plain(*msg_args)))

        upd_args = (a["adj"], a["wt"], a["wsrc"], a["w_f"], zf, g_df)
        name = f"edge_bwd_upd B={B} A={A}"
        print(f"  {name}")
        run = lambda: K.edge_bwd_upd(*upd_args)
        res = results["edge_bwd_upd"]
        res["max_abs_err"] = max(res["max_abs_err"], compare(
            name, run(), dict(zip(("g_edge", "g_wt", "g_wsrc"),
                                  K.edge_bwd_upd_plain(*upd_args))), EDGE_TOL))
        bitwise(name, run)
        add_times(res, in_turns(torch, run, lambda: K.edge_bwd_upd_plain(*upd_args)))


def check_cap_kernel(torch, dev, prot, results):
    from ai2bmd_torch.frag import runtime as RT
    from ai2bmd_torch.host import build_fragment_index
    from ai2bmd_torch.ops import caps as C

    rt = RT.FragmentRuntime.build(build_fragment_index(prot.atoms), device=dev)
    P = torch.as_tensor(prot.positions, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(1)
    base = RT.build_row_positions(rt, P)
    for label, sigma in (("template", 0.0), ("perturbed", 0.05)):
        pos = (base + sigma * torch.randn(base.shape, generator=gen).to(dev)).contiguous()
        name = f"cap_grad R={pos.shape[0]} S={pos.shape[1]} {label}"
        print(f"  {name}")
        run = lambda pos=pos: (C.amber_grad_rows(rt.ht.caps, pos),)
        res = results["cap_grad"]
        res["max_abs_err"] = max(res["max_abs_err"], compare(
            name, run(), {"grad": C.amber_grad_rows_plain(rt.ht.caps, pos)}, CAP_TOL))
        bitwise(name, run)
        if sigma:
            add_times(res, in_turns(torch, run,
                                    lambda pos=pos: C.amber_grad_rows_plain(rt.ht.caps, pos)))


def profile_steps(torch, step, state, n=3):
    """Device busy share of n MD steps and the kernels that take the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    print(f"  profiled {n} steps: {len(kernels) / n:.0f} device kernels per step, device busy "
          f"{busy_us / n / 1e3:.3f} ms of {wall_us / n / 1e3:.3f} ms per step "
          f"({100 * busy_us / wall_us:.1f}% busy, profiler on)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / n / 1e3:8.3f} ms/step  {name[:100]}")


def run_slice(torch, dev, prot, card):
    from ai2bmd_torch.frag import runtime as RT
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.potentials import FragmentPotential

    cfg = ViSNetConfig()                                   # 9 layers x 256, 8 heads, lmax 2
    params = init_params(cfg, torch.Generator().manual_seed(0))
    pot = FragmentPotential.build(prot, ViSNet(cfg, params).to(dev), cfg, longrange="mm")
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
    for name, n in launches.items():
        need(n > 0, f"kernel {name} was not launched on the main path")
    print(f"  steady state: {ms_step:.3f} ms/step over {TIMED_STEPS} steps "
          f"(smoke figure, not a benchmark; host clock, synchronised; {card})")
    profile_steps(torch, step, state)

    # step 0 against the same port on the CPU in float64 (plain versions)
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    pot64 = FragmentPotential.build(prot, ViSNet(cfg, params).to(torch.float64), cfg,
                                    longrange="mm")
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
    return launches, ms_step


def main():
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

    print("== 3. kernels against their plain versions")
    results = {n: {"max_abs_err": 0.0}
               for n in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "cap_grad")}
    check_edge_kernels(torch, dev, results)
    prot = load_protein(example_pdb("chig"))
    check_cap_kernel(torch, dev, prot, results)

    print("== 4. the slice: Chignolin, ViSNet 9 x 256, fragment MD")
    launches, ms_step = run_slice(torch, dev, prot, card)
    need(not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "JAX was imported")

    meta = {
        "edge_fwd": ("ai2bmd_torch/ops/csrc/edge_fwd.cu", "ai2bmd_tpu/ops/pallas/vismp.py:153"),
        "edge_bwd_msg": ("ai2bmd_torch/ops/csrc/edge_bwd_msg.cu",
                         "ai2bmd_tpu/ops/pallas/vismp.py:757"),
        "edge_bwd_upd": ("ai2bmd_torch/ops/csrc/edge_bwd_upd.cu",
                         "ai2bmd_tpu/ops/pallas/vismp.py:852"),
        "cap_grad": ("ai2bmd_torch/ops/csrc/cap_grad.cu", "ai2bmd_tpu/ops/pallas/caps.py:165"),
    }
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], **results[n]} for n, (src, rep) in meta.items()]
    print(f"  ms/step {ms_step:.3f} (smoke)")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
