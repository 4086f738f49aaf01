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
"""

import dataclasses

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
from ai2bmd_torch import simulators as TSIM
from ai2bmd_torch.io import trajectory as TT
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.md import simulation as TS
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.ops import LAUNCHES, _build
from ai2bmd_torch.ops import vislayer as TFL
from ai2bmd_torch.ops import vismp as TK

SMALL = dict(hidden_channels=32, num_heads=4, num_layers=3, num_rbf=8)
TINY = dict(hidden_channels=32, num_heads=4, num_layers=2, num_rbf=8)   # --model-preset tiny
T = lambda a: torch.as_tensor(np.array(a))


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
    trajectory of the protein's 175 atoms; --replicas 2 on the same input is
    still refused, naming ROADMAP item 13, whatever --solvent says."""
    conftest.require_examples()
    pdb = conftest.example_pdb("chig-preeq")
    args = ["--prot-file", pdb, "--no-solvent", "--device", "cpu", "--model-preset", "tiny",
            "--timestep", "0.25"]
    assert TCLI.main([*args, "--log-dir", str(tmp_path / "a"), "--preeq-steps", "1",
                      "--sim-steps", "4", "--record-per-steps", "2"]) == 0
    frames = TT.read_dcd(str(tmp_path / "a" / "chig-preeq-traj.dcd"))
    assert frames.shape == (2, 175, 3) and np.isfinite(frames).all()
    with pytest.raises(NotImplementedError, match="item 13"):
        TCLI.main([*args, "--log-dir", str(tmp_path / "b"), "--replicas", "2",
                   "--sim-steps", "2", "--record-per-steps", "2"])


@pytest.mark.parametrize("H, nh", [(32, 4), (64, 4), (256, 8), (64, 2), (256, 4)],
                         ids=["dh8", "dh16", "dh32", "dh32-two-heads", "dh64"])
def test_kernels_take_heads_of_8_16_and_32_channels(H, nh):
    """check_shapes, which every kernel wrapper runs, takes heads of 8, 16,
    32 and 64 channels, at a fragment and at abd's 752 slots."""
    for A in (40, 752):
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
    the JAX package's within 1e-4.  The shapes the kernels still do not
    take (H > 256, S > 8), where the JAX package runs its Pallas kernels,
    raise in check_shapes and, for a silu model on the card, in
    resolve_config, naming ROADMAP.md Queue 2.  Only another activation
    than silu resolves to the explicit plain route (ViSNetConfig.
    plain_edge_core, without fused_layer), at any shape, as the JAX package
    sends it to jnp.  H = 32 with one head of 32 channels is taken; H not a
    multiple of the head count is refused as a configuration.  S = 15
    (lmax 3) is a shape no model of either package builds (their spherical
    harmonics stop at lmax 2)."""
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
    else:
        with pytest.raises(ValueError, match=queue_2):
            TK.check_layer_shapes(176, H, S, nh)
        with pytest.raises(ValueError, match=queue_2):
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
