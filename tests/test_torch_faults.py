"""The port's three repaired faults, against the JAX package on the CPU.

1. ``solvent=False`` on a solvated input (examples/chig_preprocessed/
   chig-preeq.pdb): ProteinSimulation runs its protein alone in vacuum, as
   JAX's does, and so does ``python -m ai2bmd_torch --no-solvent``; the
   ``--replicas`` route still refuses the input.
2. ``warm_caps=False``: the stateless fragment potential, a cold cap solve
   every step, stepped on JAX's noise against JAX's Simulator.
3. Heads of 8, 16, 32 and 64 channels: the shapes the kernels take, and the
   head width each wrapper hands its launcher (the kernels' instantiation
   is chosen from H / nh); what the kernels do not take is refused on the
   card naming ROADMAP Queue 2, and other activations than silu resolve to
   the explicit plain route (Queue 3 entry 3, repaired).
4. ``SimulationConfig.write_xyz`` / ``write_dcd`` (Queue 3 entry 7,
   repaired): JAX's two fields, in its order; ``Simulator.run`` opens only
   the trajectories they select, through the native writer
   (``ai2bmd_torch.runtime``), or the Python writers when it is
   unavailable, and logs which.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from ai2bmd_tpu import simulators as JSIM
from ai2bmd_tpu.md import langevin as JL
from ai2bmd_tpu.md import simulation as JS
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_torch import cli as TCLI
from ai2bmd_torch import runtime as TRT
from ai2bmd_torch import simulators as TSIM
from ai2bmd_torch.io import trajectory as TT
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.md import simulation as TS
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.ops import LAUNCHES, _build
from ai2bmd_torch.ops import vislayer as TFL
from ai2bmd_torch.ops import vismp as TK
from test_torch_md import _make_sim
from test_torch_trajectory import DCD_TITLE

SMALL = dict(hidden_channels=32, num_heads=4, num_layers=3, num_rbf=8)
TINY = dict(hidden_channels=32, num_heads=4, num_layers=2, num_rbf=8)   # --model-preset tiny
T = lambda a: torch.as_tensor(np.array(a))


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here (see test_torch_qmmm.py's): under
    pytest-xdist the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(monkeypatch, tmp_path, pdb, model, **kw):
    """ProteinSimulation.from_pdb in both packages with JAX's weights
    bridged into the port's."""
    cfg = dict(preeq_steps=0, record_per_steps=3)
    jps = JSIM.ProteinSimulation.from_pdb(pdb, log_dir=str(tmp_path / "j"),
                                          model_cfg=JV.ViSNetConfig(**model),
                                          sim_cfg=JS.SimulationConfig(**cfg), **kw)
    jparams, _ = JSIM.load_model(None, JV.ViSNetConfig(**model))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    monkeypatch.setattr(TSIM, "load_model", lambda ckpt, cfg=None, seed=0: (tparams, cfg))
    tps = TSIM.ProteinSimulation.from_pdb(pdb, log_dir=str(tmp_path / "t"),
                                          model_cfg=TV.ViSNetConfig(**model),
                                          sim_cfg=TS.SimulationConfig(**cfg), device="cpu", **kw)
    return jps, tps


def test_no_solvent_on_a_solvated_input_matches_jax(monkeypatch, tmp_path):
    """solvent=False on the solvated Chignolin box, 3 x 32: both packages
    select the 175 protein atoms and run them in vacuum fragment mode with
    warm caps.  The first forces agree within 1e-4 eV/A; the cold cap
    offsets within 1e-4 A (10 float32 L-BFGS iterations from this box's
    geometry part by up to ~6e-5 A between the two packages' roundings)."""
    conftest.require_examples()
    jps, tps = _both(monkeypatch, tmp_path, conftest.example_pdb("chig-preeq"), SMALL,
                     solvent=False)
    assert len(tps.prot) == len(jps.prot) == 175 and tps.prot_name == "chig-preeq"
    np.testing.assert_array_equal(tps.prot.numbers, jps.prot.numbers)
    np.testing.assert_array_equal(tps.prot.positions, jps.prot.positions)
    np.testing.assert_allclose(tps.sim._init_aux.numpy(), np.asarray(jps.sim._init_aux),
                               rtol=0, atol=1e-4)
    sj = jps.sim.initial_state(jps.prot.positions)
    st = tps.sim.initial_state(tps.prot.positions)
    assert float(np.abs(np.asarray(sj.forces)).max()) > 1e-3
    np.testing.assert_allclose(st.forces.numpy(), np.asarray(sj.forces), rtol=0, atol=1e-4)


def _jax_noise(key, shape):
    """(xi, eta) that JAX's langevin_step draws from ``key``."""
    _, k1, k2 = jax.random.split(key, 3)
    return (jax.random.normal(k1, shape, jnp.float32), jax.random.normal(k2, shape, jnp.float32))


def test_cold_caps_every_step_match_jax(monkeypatch, tmp_path):
    """warm_caps=False: both Simulators step the stateless fragment
    potential (caps placed and solved cold with 10 L-BFGS iterations each
    step, no carry), with the tiny model.  Three Langevin steps of the port
    fed JAX's noise from JAX's velocities against JAX's Simulator._chunk,
    both from the port's step-0 forces (JAX's own would compile the
    potential a second time); the forces of steps 1-3 are each package's
    own.  Tolerances: positions 1e-5 A, forces 1e-4 eV/A, energy 1e-4 eV."""
    conftest.require_examples()
    jps, tps = _both(monkeypatch, tmp_path, conftest.example_pdb("chig"), TINY,
                     warm_caps=False)
    assert tps.sim._init_aux is None and tps.potential.rt.opt_iters == 10
    P = jps.prot.positions.astype(np.float32)
    key = jax.random.PRNGKey(2)
    vel = JL.maxwell_boltzmann_velocities(key, jps.prot.masses, 300.0)
    st = tps.sim.initial_state(P)
    assert st.aux is None and float(st.forces.abs().max()) > 1e-3
    sj = JL.MDState(jnp.asarray(P), vel, jnp.asarray(st.forces.numpy()),
                    jnp.asarray(st.energy.numpy()), key, jnp.asarray(0, jnp.int32), aux=())
    sj_end = jps.sim._chunk(sj, jnp.asarray(P), jnp.asarray(0.0, jnp.float32), 3)

    st = TL.MDState(T(P), T(vel), st.forces, st.energy)
    for _ in range(3):
        xi, eta = _jax_noise(key, P.shape)
        key = jax.random.split(key, 3)[0]
        st = TL.langevin_step(tps.sim.full_potential, tps.sim.coeffs, tps.sim.masses, st,
                              xi=T(xi), eta=T(eta))
    assert st.step == 3 and st.aux is None
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj_end.positions), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(st.forces.numpy(), np.asarray(sj_end.forces), rtol=0, atol=1e-4)
    assert float(st.energy) == pytest.approx(float(sj_end.energy), abs=1e-4)


def test_cli_no_solvent_runs_a_solvated_input_in_vacuum(tmp_path):
    """python -m ai2bmd_torch --no-solvent on the solvated box exits 0 with a
    trajectory of the protein's 175 atoms, and so does --replicas 2 on the
    same input: the replica ensemble of its protein in vacuum, a DCD of 175
    atoms a replica (the solvated ensemble runs without --no-solvent:
    tests/test_torch_solvated_ensemble.py)."""
    conftest.require_examples()
    pdb = conftest.example_pdb("chig-preeq")
    args = ["--prot-file", pdb, "--no-solvent", "--device", "cpu", "--model-preset", "tiny",
            "--timestep", "0.25"]
    assert TCLI.main([*args, "--log-dir", str(tmp_path / "a"), "--preeq-steps", "1",
                      "--sim-steps", "4", "--record-per-steps", "2"]) == 0
    frames = TT.read_dcd(str(tmp_path / "a" / "chig-preeq-traj.dcd"))
    assert frames.shape == (2, 175, 3) and np.isfinite(frames).all()
    assert TCLI.main([*args, "--log-dir", str(tmp_path / "b"), "--replicas", "2",
                      "--sim-steps", "2", "--record-per-steps", "2"]) == 0
    for r in range(2):
        frames = TT.read_dcd(str(tmp_path / "b" / f"chig-preeq-r{r:03d}-traj.dcd"))
        assert frames.shape == (1, 175, 3) and np.isfinite(frames).all()


@pytest.mark.parametrize("H, nh", [(32, 4), (64, 4), (256, 8), (64, 2), (256, 4), (256, 2),
                                   (512, 2), (48, 2)],
                         ids=["dh8", "dh16", "dh32", "dh32-two-heads", "dh64", "dh128", "dh256",
                              "H48-dh24"])
def test_kernels_take_heads_of_8_16_and_32_channels(H, nh):
    """check_shapes, which every edge-kernel wrapper runs, and
    check_layer_shapes (K5/K6) take heads of 8, 16, 32 and 64 channels, at
    a fragment, at abd's 752 slots and at 1,112 slots.  Heads of 128 and
    256 channels and H = 48 with two heads of 24 are both families' wide
    instantiations (narrow_shapes is False there): both checks take them
    too."""
    wide = (H, nh) in ((256, 2), (512, 2), (48, 2))
    assert TK.narrow_shapes(H, nh) is not wide
    assert TK.layer_shapes(H, nh, 8)
    for A in (40, 752, 1112):
        TK.check_shapes(A, H, 8, nh)
        TK.check_layer_shapes(A, H, 8, nh)


@pytest.mark.parametrize("H, nh, S", [(256, 4, 8), (32, 1, 8), (64, 3, 8), (512, 16, 8),
                                      (256, 8, 15)],
                         ids=["dh64", "dh32-H32-one-head", "uneven", "H512", "lmax3"])
def test_what_the_kernels_refuse_names_queue_3(H, nh, S):
    """Heads of 64 channels are in the kernels' domain (head_sum<64>, two
    warps a head): check_shapes takes them, a silu model at them keeps the
    kernels on the card, and the forward that the CPU runs (the kernels'
    plain versions; 3 layers at H = 256, two fragments of 16 slots) matches
    the JAX package's within 1e-4.  H = 512 with 16 heads is both kernel
    families' wide instantiation: check_shapes and check_layer_shapes take
    it, a silu model there keeps K1-K3 on the card, and one that asks for
    the full-layer kernels (fused_layer) keeps K5/K6.  S > 8, where neither
    package builds a model, raises in check_shapes, check_layer_shapes and
    resolve_config.  Only another activation than silu resolves to the
    explicit plain route (ViSNetConfig.plain_edge_core, without
    fused_layer), at any shape, as the JAX package sends it to jnp.  H = 32
    with one head of 32 channels is taken; H not a multiple of the head
    count is refused as a configuration.  S = 15 (lmax 3) is a shape no
    model of either package builds (their spherical harmonics stop at lmax
    2)."""
    lmax = {8: 2, 15: 3}[S]
    kw = dict(hidden_channels=H, num_heads=nh, num_layers=3, num_rbf=8, max_z=20, lmax=lmax)
    queue_2 = "ROADMAP.md, Queue 2: domain still to extend"
    if H % nh:
        with pytest.raises(ValueError, match=queue_2):
            TK.check_layer_shapes(176, H, S, nh)
        with pytest.raises(ValueError, match="not a multiple of num_heads"):
            TV.resolve_config(TV.ViSNetConfig(**kw), "cuda")
        return
    other = dataclasses.replace(TV.ViSNetConfig(**kw), activation="tanh", fused_layer=True)
    plain = TV.resolve_config(other, "cuda")
    assert plain.plain_edge_core and not plain.fused_layer
    assert TV.resolve_config(other, "cpu") is other
    if H <= 256 and S <= 8:
        TK.check_shapes(176, H, S, nh)
        TK.check_layer_shapes(176, H, S, nh)
        assert not TV.resolve_config(TV.ViSNetConfig(**kw), "cuda").plain_edge_core
    elif S <= 8:
        TK.check_shapes(176, H, S, nh)
        TK.check_layer_shapes(176, H, S, nh)
        kernels = TV.resolve_config(TV.ViSNetConfig(**kw), "cuda")
        assert not kernels.plain_edge_core and not kernels.fused_layer
        fused = TV.resolve_config(TV.ViSNetConfig(**kw, fused_layer=True), "cuda")
        assert fused.fused_layer and not fused.plain_edge_core
    else:
        for check in (TK.check_shapes, TK.check_layer_shapes):
            with pytest.raises(ValueError, match=queue_2):
                check(176, H, S, nh)
        with pytest.raises(ValueError, match="no model of either package builds S > 8"):
            TV.resolve_config(TV.ViSNetConfig(**kw), "cuda")
    if H // nh != 64:
        return
    cfg = TV.ViSNetConfig(**kw)
    jcfg = JV.ViSNetConfig(**kw)
    jparams = JV.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    z = rng.integers(1, 9, size=(2, 16))
    pos = (rng.normal(size=(2, 16, 3)) * 1.5).astype(np.float32)
    mask = np.ones((2, 16), bool)
    mask[1, 12:] = False
    e_j, f_j = jax.jit(lambda p, *a: JV.energy_and_forces(p, *a, jcfg))(
        jparams, jnp.asarray(z), jnp.asarray(pos), jnp.asarray(mask))
    e_t, f_t = TV.energy_and_forces(params_from_jax(jax.tree.map(np.asarray, jparams)), T(z),
                                    T(pos), T(mask), cfg)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)


def test_the_plain_route_counts_its_calls_on_the_card_only(monkeypatch, rng):
    """edge_core(plain=True) runs the plain forward on any device; a call on
    CUDA tensors adds one to LAUNCHES["plain_edge_core"] (the counter
    chip_smoke.py holds at 0 on every kernel path), one on CPU tensors does
    not."""
    B, A, H, S, nh = 1, 8, 64, 8, 1
    f = lambda *s: T(rng.standard_normal(s).astype(np.float32))
    args = (f(B, A, H), f(B, A, H), f(B, A, H), f(B, A, S, H), f(B, A, A, H), f(B, A, A, S),
            f(B, A, A).abs(), torch.ones(B, A, A), f(H, 2 * H), f(2 * H), f(H, 2 * H), f(2 * H))
    saved = dict(LAUNCHES)
    try:
        want = TK.edge_fwd_plain(*args, 5.0, nh)[:3]
        got = TK.edge_core(*args, 5.0, nh, plain=True)
        assert LAUNCHES["plain_edge_core"] == saved["plain_edge_core"]
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
        got_card = TK.edge_core(*args, 5.0, nh, plain=True)
        assert LAUNCHES["plain_edge_core"] == saved["plain_edge_core"] + 1
    finally:
        LAUNCHES.update(saved)
    for a, b, c in zip(got, want, got_card):
        assert (a is None and b is None) or (torch.equal(a, b) and torch.equal(c, b))


@pytest.fixture
def launches(monkeypatch):
    """The kernel wrappers' launch path on CPU tensors: route() says
    "kernel", the argument checks pass, and each ``_build.call`` is recorded
    instead of run.  Yields the list of (name, argtypes, args)."""
    calls = []
    monkeypatch.setattr(TK, "route", lambda t, kernels="edge-core": True)
    monkeypatch.setattr(TFL, "route", lambda t, kernels="fused-layer": True)
    monkeypatch.setattr(_build, "check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "call", lambda name, argtypes, *args: calls.append(
        (name, argtypes, args)))
    saved = dict(LAUNCHES)
    yield calls
    LAUNCHES.update(saved)


@pytest.mark.parametrize("H, nh", [(32, 4), (64, 4), (64, 2), (128, 2)],
                         ids=["dh8", "dh16", "dh32", "dh64"])
def test_wrappers_hand_their_launcher_the_head_width(launches, rng, H, nh):
    """K1, K2, K7, K5 and K6's wrappers pass H / nh as the launcher's last
    argument, and as many arguments as its C signature takes (the stream
    is added by _build.call)."""
    B, A, S = 1, 16, 8
    f = lambda *s: T(rng.standard_normal(s).astype(np.float32))
    q, vec, edge, dsh, d = f(B, A, H), f(B, A, S, H), f(B, A, A, H), f(B, A, A, S), f(B, A, A)
    w2, b2 = f(H, 2 * H), f(2 * H)
    TK.edge_fwd(q, q, q, vec, edge, dsh, d, d, w2, b2, w2, b2, 5.0, nh, wt=vec, wsrc=vec,
                w_f=f(H, H), b_f=f(H), store=True)
    TK.edge_bwd_msg(q, q, q, vec, f(B, A, A, 2 * H), f(B, A, A, 2 * H), dsh, d, d, w2, w2, q,
                    vec, 5.0, nh)
    TK.edge_bwd_msg_rc(q, q, q, vec, edge, dsh, d, d, w2, b2, w2, b2, q, vec, 5.0, nh)
    lw = {n: f(*s) for n, s in dict(
        ln_s=(H,), ln_b=(H,), vln_w=(H,), w_qkv=(H, 3 * H), b_qkv=(3 * H,), w_vp=(H, 3 * H),
        w_dkv=(H, 2 * H), b_dkv=(2 * H,), w_s=(H, 2 * H), b_s=(2 * H,), w_o=(H, 3 * H),
        b_o=(3 * H,), w_t=(H, H), w_src=(H, H), w_f=(H, H), b_f=(H,), pool=(H, nh)).items()}
    weights = [lw[n] for n in TFL.WEIGHT_NAMES]
    x, vsm, dsm = f(B, A, H), f(B, S, A, H), f(B, S, A, A)
    TFL.vislayer_fwd(x, vsm, edge, dsm, d, d, weights, 5.0, nh, False)
    TFL.vislayer_bwd(x, vsm, edge, dsm, d, d, weights, x, x, vsm, edge, 5.0, nh, False)
    names = [c[0] for c in launches]
    assert names == ["edge_fwd_launch", "edge_bwd_msg_launch", "edge_bwd_msg_rc_launch",
                     "vislayer_fwd_launch", "vislayer_bwd_launch"]
    for name, argtypes, args in launches:
        assert len(args) == len(argtypes), name
        assert args[-1] == H // nh and argtypes[-1] is _build.I, name


def test_simulation_config_has_jax_fields_in_jax_order():
    assert ([f.name for f in dataclasses.fields(TS.SimulationConfig)]
            == [f.name for f in dataclasses.fields(JS.SimulationConfig)])
    cfg = TS.SimulationConfig(write_xyz=False, write_dcd=True)
    assert (cfg.write_xyz, cfg.write_dcd) == (False, True)
    assert TS.SimulationConfig().write_xyz and TS.SimulationConfig().write_dcd


def _run_lj(log_dir, **flags):
    """The LJ cluster of tests/test_torch_md.py (27 atoms), 30 steps recorded
    every 10, with these write flags -> (state, log lines)."""
    sim, P = _make_sim(log_dir)
    sim.cfg = dataclasses.replace(sim.cfg, **flags)
    logs = []
    state = sim.run(sim.initial_state(P), 30, log=logs.append)
    return state, logs


@pytest.mark.parametrize("write_xyz, write_dcd",
                         [(True, True), (True, False), (False, True), (False, False)])
def test_write_flags_select_the_trajectory_files(tmp_path, write_xyz, write_dcd):
    """Only the selected trajectories are written, the metrics CSV and the
    restart file always; through the native writer when it is available
    (its DCD title names it), and the run logs which writer."""
    state, logs = _run_lj(tmp_path, write_xyz=write_xyz, write_dcd=write_dcd)
    files = sorted(os.listdir(tmp_path))
    want = ["lj-metrics.csv", "lj-restart.npz"]
    want += ["lj-traj.dcd"] * write_dcd + ["lj-traj.xyz"] * write_xyz
    assert files == sorted(want)
    lines = [ln for ln in logs if ln.startswith("trajectory:")]
    native = TRT.native_available()
    if not (write_xyz or write_dcd):
        assert lines == []
        return
    kinds = ", ".join(k for k, on in (("XYZ", write_xyz), ("DCD", write_dcd)) if on)
    if native:
        assert lines == [f"trajectory: native writer ({kinds})"]
    else:
        assert len(lines) == 1 and lines[0].startswith(f"trajectory: Python writers ({kinds};")
    if write_xyz:
        assert (tmp_path / "lj-traj.xyz").read_text().count("step=") == 3
    if write_dcd:
        raw = (tmp_path / "lj-traj.dcd").read_bytes()
        assert (b"native runtime" in raw[DCD_TITLE]) == native
        frames = TT.read_dcd(str(tmp_path / "lj-traj.dcd"))
        assert frames.shape == (3, 27, 3)
        np.testing.assert_array_equal(frames[-1], state.positions.numpy())


def test_python_writers_when_the_native_runtime_is_unavailable(monkeypatch, tmp_path):
    """With the native runtime made unavailable, the same files come from the
    Python writers, the fallback is logged, and the frames equal the native
    run's bitwise (the CPU run is deterministic for a fixed seed): XYZ bytes
    equal, DCD bytes equal but for the title record."""
    if not TRT.native_available():
        pytest.skip("native runtime unavailable: there is no native run to compare")
    _run_lj(tmp_path / "native")

    def unavailable():
        raise RuntimeError("native runtime unavailable: made so by the test")

    monkeypatch.setattr(TRT, "library", unavailable)
    _, logs = _run_lj(tmp_path / "python")
    assert [ln for ln in logs if ln.startswith("trajectory:")] == [
        "trajectory: Python writers (XYZ, DCD; native runtime unavailable: made so by the test)"]
    for d in ("native", "python"):
        assert sorted(os.listdir(tmp_path / d)) == ["lj-metrics.csv", "lj-restart.npz",
                                                    "lj-traj.dcd", "lj-traj.xyz"]
    nat, py = (tmp_path / "native" / "lj-traj.dcd").read_bytes(), \
        (tmp_path / "python" / "lj-traj.dcd").read_bytes()
    assert len(nat) == len(py)
    assert nat[:DCD_TITLE.start] == py[:DCD_TITLE.start]
    assert nat[DCD_TITLE.stop:] == py[DCD_TITLE.stop:]
    assert b"native runtime" in nat[DCD_TITLE] and b"native runtime" not in py[DCD_TITLE]
    assert ((tmp_path / "native" / "lj-traj.xyz").read_bytes()
            == (tmp_path / "python" / "lj-traj.xyz").read_bytes())
