"""Port parity of the whole slice on Chignolin (ai2bmd_torch vs ai2bmd_tpu):
FragmentPotential with the "mm" long range, warm caps, and Langevin steps
fed the noise that JAX draws.  Small ViSNet (3 layers x 32), float32, CPU.
Also: the port loads neither JAX nor the JAX package, its own copies of the
host modules agree with the JAX package's, its entry points take the card
unless told otherwise, and it never falls back silently."""

import dataclasses
import glob
import os
import re
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from ai2bmd_tpu import potentials as JP
from ai2bmd_tpu.md import langevin as JL
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_torch import potentials as TP
from ai2bmd_torch.frag import runtime as TRT
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.ops import caps as TC
from ai2bmd_torch.ops import vislayer as TFL
from ai2bmd_torch.ops import vismp as TK
from ai2bmd_torch import cli as TCLI
from ai2bmd_torch import simulators as TSIM
from ai2bmd_torch.md import constraints as TMC
from ai2bmd_torch.md import simulation as TSIMU
from ai2bmd_torch.parallel import ReplicaEnsemble
from ai2bmd_torch.physics import nonbonded as TN
from ai2bmd_torch.utils import device as TD

SMALL = dict(hidden_channels=32, num_heads=4, num_layers=3, num_rbf=8, max_z=20)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = lambda a: torch.as_tensor(np.array(a))


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here (see test_torch_qmmm.py's): under
    pytest-xdist the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pots(chig_protein):
    jcfg = JV.ViSNetConfig(**SMALL)
    jparams = JV.init_params(jax.random.PRNGKey(0), jcfg)
    jpot = JP.FragmentPotential.build(chig_protein, jparams, jcfg, longrange="mm")
    tcfg = TV.ViSNetConfig(**SMALL)
    module = TV.ViSNet(tcfg, params_from_jax(jax.tree.map(np.asarray, jparams)))
    tpot = TP.FragmentPotential.build(chig_protein, module, tcfg, longrange="mm", device="cpu")
    warm = jax.jit(lambda P, aux: jpot.stateful_energy_forces(P, aux, warm_iters=1))
    return jpot, tpot, warm, np.asarray(chig_protein.positions, np.float32)


def test_stateful_energy_forces_match_jax(pots):
    """Cold caps (10 iterations), then one warm step of E, F and the new cap
    offsets from the same offsets.  Tolerances: E 1e-4 eV, F 1e-4 eV/A (float32
    sums over 13 fragments and 175 atoms in another order), cap offsets 1e-5 A."""
    jpot, tpot, warm, P = pots
    aux_j = np.asarray(jax.jit(jpot.init_cap_delta)(jnp.asarray(P)))
    aux_t = tpot.init_cap_delta(T(P))
    np.testing.assert_allclose(aux_t.numpy(), aux_j, rtol=0, atol=1e-5)

    e_j, f_j, new_j = warm(jnp.asarray(P), jnp.asarray(aux_j))
    e_t, f_t, new_t = tpot.stateful_energy_forces(T(P), T(aux_j))
    assert f_t.shape == (175, 3) and torch.isfinite(f_t).all()
    assert float(e_t) == pytest.approx(float(e_j), abs=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(new_t.numpy(), np.asarray(new_j), rtol=0, atol=1e-5)


def test_cold_start_takes_ten_iterations_whatever_opt_iters(pots, chig_protein):
    """At opt_iters=5 the reference's FragmentPotential still cold-starts the
    caps with initial_cap_delta's 10 iterations; so does the port.  The
    cold-start offsets and the first warm forces against JAX, tolerances as
    test_stateful_energy_forces_match_jax."""
    jpot, tpot, _, P = pots
    jpot5 = JP.FragmentPotential.build(chig_protein, jpot.params, jpot.cfg, longrange="mm",
                                       opt_iters=5)
    tpot5 = TP.FragmentPotential.build(chig_protein, tpot.module, tpot.cfg, longrange="mm",
                                       opt_iters=5, device="cpu")
    assert tpot5.rt.opt_iters == 5
    aux_j = np.asarray(jax.jit(jpot5.init_cap_delta)(jnp.asarray(P)))
    aux_t = tpot5.init_cap_delta(T(P))
    np.testing.assert_allclose(aux_t.numpy(), aux_j, rtol=0, atol=1e-5)
    e_j, f_j, _ = jax.jit(lambda P, aux: jpot5.stateful_energy_forces(P, aux))(
        jnp.asarray(P), jnp.asarray(aux_j))
    e_t, f_t, _ = tpot5.stateful_energy_forces(T(P), aux_t)
    assert float(e_t) == pytest.approx(float(e_j), abs=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)


def test_cold_energy_forces_match_jax(pots):
    """The stateless path: caps cold-started with 10 iterations inside the
    call.  Tolerances as above."""
    jpot, tpot, _, P = pots
    e_j, f_j = jax.jit(jpot.energy_forces)(jnp.asarray(P))
    e_t, f_t = tpot.energy_forces(T(P))
    assert float(e_t) == pytest.approx(float(e_j), abs=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)


def test_langevin_steps_match_jax_with_its_noise(pots, chig_protein):
    """Three warm Langevin steps (1 fs, 300 K, 0.001/fs) from one state.  The
    port takes the xi/eta that ai2bmd_tpu/md/langevin.py:108-111 draws,
    reproduced here with the same key splits.  Tolerances: positions 1e-5 A,
    velocities 1e-5 A/t, forces 2e-4 eV/A, E 2e-4 eV (float32 over steps)."""
    jpot, tpot, warm, P = pots
    masses = chig_protein.masses
    key = jax.random.PRNGKey(0)
    aux0 = jax.jit(jpot.init_cap_delta)(jnp.asarray(P))
    e0, f0, aux0 = warm(jnp.asarray(P), aux0)
    vel = JL.maxwell_boltzmann_velocities(key, masses, 300.0)
    sj = JL.MDState(jnp.asarray(P), vel, f0, e0, key, jnp.asarray(0), aux=aux0)
    st = TL.MDState(T(P), T(vel), T(f0), T(e0), aux=T(aux0))
    cj = JL.LangevinCoeffs.build(masses, 1.0, 300.0, 0.001)
    ct = TL.LangevinCoeffs.build(masses, 1.0, 300.0, 0.001, device="cpu")
    m = torch.as_tensor(masses, dtype=torch.float32)
    step = jax.jit(lambda s: JL.langevin_step(warm, cj, masses, s))
    for _ in range(3):
        _, k1, k2 = jax.random.split(sj.key, 3)
        xi = jax.random.normal(k1, P.shape, jnp.float32)
        eta = jax.random.normal(k2, P.shape, jnp.float32)
        sj = step(sj)
        st = TL.langevin_step(tpot.stateful_energy_forces, ct, m, st, xi=T(xi), eta=T(eta))
    assert st.step == 3
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj.positions), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.velocities.numpy(), np.asarray(sj.velocities), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(st.forces.numpy(), np.asarray(sj.forces), rtol=0, atol=2e-4)
    assert float(st.energy) == pytest.approx(float(sj.energy), abs=2e-4)


def test_generator_noise_is_reproducible(pots, chig_protein):
    """Without xi/eta the step draws from the generator it is given."""
    _, tpot, _, P = pots
    m = torch.as_tensor(chig_protein.masses, dtype=torch.float32)
    ct = TL.LangevinCoeffs.build(chig_protein.masses, 1.0, 300.0, 0.001, device="cpu")
    pot = lambda x, aux: (x.new_zeros(()), torch.zeros_like(x), aux)   # free flight
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        v = TL.maxwell_boltzmann_velocities(g, chig_protein.masses, 300.0)
        s = TL.MDState(T(P), v, torch.zeros_like(v), torch.zeros(()))
        runs.append(TL.langevin_step(pot, ct, m, s, generator=g).positions)
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], T(P))
    with pytest.raises(ValueError):
        TL.langevin_step(pot, ct, m, TL.MDState(T(P), v, v, torch.zeros(())))


def test_pme_long_range_matches_jax(chig_protein, pots):
    """FragmentPotential(longrange="pme") (refused until ROADMAP item 12 was
    ported) on Chignolin's CRYST1 cell at 3 x 32: the PME term alone, and one
    warm step of the whole potential from the port's cold caps, E and F
    against the JAX package's within 1e-4.  JAX's warm "pme" step is its
    warm "mm" step (the module's compiled `warm`) with the long range
    swapped: JAX's FragmentPotential adds its long-range term to the same
    fragment sum (ai2bmd_tpu/potentials.py:80-87)."""
    jpot, tpot, warm, P = pots
    from ai2bmd_tpu.physics import nonbonded as JN
    from ai2bmd_tpu.physics import pme as JPME
    from ai2bmd_torch.physics import pme as TPME

    jp = JP.FragmentPotential.build(chig_protein, jpot.params, jpot.cfg, longrange="pme")
    tp = TP.FragmentPotential.build(chig_protein, tpot.module, tpot.cfg, longrange="pme",
                                    device="cpu")
    assert tp.nb is None and tp.pme.grid == jp.pme.grid
    e_j, f_j = jax.jit(lambda p: JPME.pme_energy_forces(jp.pme, p))(jnp.asarray(P))
    e_t, f_t = TPME.pme_energy_forces(tp.pme, T(P))
    assert float(e_t) == pytest.approx(float(e_j), abs=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)
    aux = tp.init_cap_delta(T(P))
    e_mm, f_mm, _ = warm(jnp.asarray(P), jnp.asarray(aux.numpy()))
    e_nb, f_nb = jax.jit(lambda p: JN.nonbonded_energy_forces(jpot.nb, p))(jnp.asarray(P))
    e_j, f_j = e_mm - e_nb + e_j, f_mm - f_nb + f_j
    e_t, f_t, _ = tp.stateful_energy_forces(T(P), aux)
    assert float(e_t) == pytest.approx(float(e_j), abs=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)


def test_port_never_imports_jax():
    """A tiny CPU slice in a fresh interpreter, through the full-layer path
    and the edge-core path, with the CLI, the Simulator, ProteinSimulation,
    the trajectory IO, preprocessing, the peptide builder and the ensembles
    imported, and one frame written through the native runtime (when g++
    builds it): neither JAX nor any ai2bmd_tpu module
    loads, and no kernel launch is counted (CPU tensors take the plain
    versions)."""
    code = textwrap.dedent("""
        import dataclasses, sys, torch
        from ai2bmd_torch.host import example_pdb, load_protein
        from ai2bmd_torch.md import langevin as L
        from ai2bmd_torch.models.params import init_params
        from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
        from ai2bmd_torch.ops import LAUNCHES
        from ai2bmd_torch.potentials import FragmentPotential
        import ai2bmd_torch.cli, ai2bmd_torch.md.simulation, ai2bmd_torch.simulators
        import ai2bmd_torch.io.trajectory, ai2bmd_torch.tools.traj2dcd
        import ai2bmd_torch.preprocess, ai2bmd_torch.io.build, ai2bmd_torch.parallel
        prot = load_protein(example_pdb("chig"))
        cfg = ViSNetConfig(hidden_channels=32, num_heads=1, num_layers=2, num_rbf=8, max_z=20)
        params = init_params(cfg, torch.Generator().manual_seed(0))
        P = torch.as_tensor(prot.positions, dtype=torch.float32)
        for c in (cfg, dataclasses.replace(cfg, fused_layer=True)):
            pot = FragmentPotential.build(prot, ViSNet(c, params), c, device="cpu")
            aux = pot.init_cap_delta(P)
            e, f, aux = pot.stateful_energy_forces(P, aux)
            g = torch.Generator().manual_seed(0)
            s = L.MDState(P, L.maxwell_boltzmann_velocities(g, prot.masses, 300.0), f, e, aux=aux)
            s = L.langevin_step(pot.stateful_energy_forces,
                                L.LangevinCoeffs.build(prot.masses, 1.0, 300.0, 0.001, device="cpu"),
                                torch.as_tensor(prot.masses, dtype=torch.float32), s, generator=g)
            assert torch.isfinite(s.positions).all() and torch.isfinite(s.forces).all()
        import os, tempfile
        from ai2bmd_torch import runtime
        if runtime.native_available():
            with tempfile.TemporaryDirectory() as d:
                w = runtime.AsyncTrajectoryWriter(os.path.join(d, "t.dcd"), None, prot.numbers)
                w.write(s.positions.numpy(), energy=float(s.energy), step=1)
                w.close()
                got = ai2bmd_torch.io.trajectory.read_dcd(os.path.join(d, "t.dcd"))
                assert (got[0] == s.positions.numpy()).all()
        assert not any(m == "jax" or m.startswith(("jax.", "jaxlib")) for m in sys.modules)
        print(sorted(m for m in sys.modules if m.startswith("ai2bmd_tpu")))
        print(dict(LAUNCHES))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")   # one thread, as one_thread above
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    loaded, launches = out.stdout.strip().splitlines()[-2:]
    assert eval(loaded) == [], loaded
    assert set(eval(launches).values()) == {0}


def test_port_sources_never_import_the_jax_package():
    """No file of the port, nor chip_smoke.py or bench_torch.py, imports
    ai2bmd_tpu or JAX."""
    pattern = re.compile(r"^\s*(from|import)\s+(ai2bmd_tpu|jax|jaxlib)\b", re.M)
    files = sorted(glob.glob(os.path.join(REPO, "ai2bmd_torch", "**", "*.py"), recursive=True))
    files += [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "bench_torch.py")]
    assert os.path.join(REPO, "ai2bmd_torch", "md", "graphed.py") in files
    assert len(files) > 20
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert offenders == []


def test_require_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.require_cuda()


def test_entry_points_default_to_the_card(monkeypatch, pots, chig_protein, tmp_path):
    """Given no device, the entry points take the card, and without one they
    raise the require_cuda error; device="cpu" runs on the CPU."""
    _, tpot, _, P = pots
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = TV.ViSNet(tpot.cfg, tpot.module.params())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.FragmentPotential.build(chig_protein, module, tpot.cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRT.FragmentRuntime.build(tpot.fi)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.LangevinCoeffs.build(chig_protein.masses, 1.0, 300.0, 0.001)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaEnsemble.build(chig_protein, tpot.fi, module.params(), tpot.cfg, n_replicas=2)
    with pytest.raises(ValueError, match="3 replicas do not shard over dp=2"):
        ReplicaEnsemble.build(chig_protein, tpot.fi, module.params(), tpot.cfg, n_replicas=3,
                              device="cpu", mesh=SimpleNamespace(size=lambda dim: (2, 1)[dim]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TN.NonbondedParams.build(chig_protein, tpot.fi.exclusion_mask())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMC.BondRestraint.find_hydrogen_bonds(chig_protein.atoms)
    lone = lambda p: (p.sum() * 0, torch.zeros_like(p))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSIMU.Simulator(lone, chig_protein.masses, chig_protein.numbers,
                        TSIMU.SimulationConfig(), str(tmp_path), "chig")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSIM.ProteinSimulation.from_pdb(conftest.example_pdb("chig"), log_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCLI.main(["--prot-file", conftest.example_pdb("chig"), "--log-dir", str(tmp_path)])
    assert TN.NonbondedParams.build(chig_protein, tpot.fi.exclusion_mask(),
                                    device="cpu").mask.device.type == "cpu"
    pot = TP.FragmentPotential.build(chig_protein, module, tpot.cfg, device="cpu")
    e, f, _ = pot.stateful_energy_forces(T(P), pot.init_cap_delta(T(P)))
    assert f.device.type == "cpu" and torch.isfinite(f).all() and torch.isfinite(e)


def test_resolve_config_selects_the_full_layer_path_on_the_card_only(monkeypatch):
    """AI2BMD_FUSED_LAYER=1 switches a model on the card to the full-layer
    kernels; a model on the CPU, or a config that already chose, is left as
    it is."""
    cfg = TV.ViSNetConfig(**SMALL)
    monkeypatch.setenv("AI2BMD_FUSED_LAYER", "1")
    assert TV.resolve_config(cfg, "cuda").fused_layer
    assert not TV.resolve_config(cfg, "cpu").fused_layer
    monkeypatch.delenv("AI2BMD_FUSED_LAYER")
    assert not TV.resolve_config(cfg, "cuda").fused_layer
    on = dataclasses.replace(cfg, fused_layer=True)
    assert TV.resolve_config(on, "cpu") is on


HOST_PDBS = ["chig", "trpcage", "ww", "abd", "chig-preeq"]


def _same(a, b, path="") -> None:
    """a == b, recursing through dataclasses, dicts and sequences; arrays equal
    in shape, dtype and every element."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("name", HOST_PDBS)
def test_host_copies_match_the_jax_package(name):
    """The port's own copies of the host modules (io, system, frag.indexer,
    frag.topology, data, data.protein_topology, units) give what the JAX
    package's give: Protein, FragmentIndex, TypeTopology and the MM
    SystemTopology on each bundled example, the solvated Chignolin box
    (fragments of its protein) among them."""
    from ai2bmd_tpu import units as JU
    from ai2bmd_tpu.data import protein_topology as JPT
    from ai2bmd_tpu.frag import indexer as JI
    from ai2bmd_tpu.frag import topology as JT
    from ai2bmd_tpu.io.pdb import read_pdb as j_read
    from ai2bmd_tpu.io.reorder import normalize_atom_order as j_norm
    from ai2bmd_tpu.system import Protein as JProtein
    from ai2bmd_torch import host as H
    from ai2bmd_torch.data import protein_topology as TPT

    conftest.require_examples()
    path = conftest.example_pdb(name)
    j_atoms, t_atoms = j_norm(j_read(path)), H.normalize_atom_order(H.read_pdb(path))
    _same(t_atoms, j_atoms, "atoms")
    j_prot, t_prot = JProtein.from_atoms(j_atoms), H.Protein.from_atoms(t_atoms)
    _same(t_prot, j_prot, "protein")
    _same(TPT.build_topology(t_atoms), JPT.build_topology(j_atoms), "system_topology")
    sel = j_prot.protein_indices()
    if len(sel) < len(j_prot):        # a solvated box: the protein's fragments
        j_atoms, t_atoms = j_prot.select(sel).atoms, t_prot.select(sel).atoms
    j_fi, t_fi = JI.build_fragment_index(j_atoms), H.build_fragment_index(t_atoms)
    _same(t_fi, j_fi, "fragment_index")
    types = sorted({t for t in j_fi.row_prmtop if t})
    _same(H.build_type_topology(types), JT.build_type_topology(types), "topology")
    assert {k: v for k, v in vars(H.units).items() if isinstance(v, float)} == \
        {k: v for k, v in vars(JU).items() if isinstance(v, float)}


def test_wrappers_refuse_other_devices(pots):
    """A tensor that is neither on the CPU nor on the card is refused, not
    routed to a plain version."""
    _, tpot, _, _ = pots
    meta = torch.empty((2, 16, 256), device="meta")
    with pytest.raises(ValueError, match="no edge-core implementation"):
        TK.edge_core(meta, meta, meta, meta, meta, meta, meta, meta, meta, meta, meta, meta,
                     5.0, 8)
    with pytest.raises(ValueError, match="no edge-core implementation"):
        TK.edge_core(meta, meta, meta, meta, meta, meta, meta, meta, meta, meta, meta, meta,
                     5.0, 8, recompute=True)
    with pytest.raises(ValueError, match="no edge-core implementation"):
        TK.edge_bwd_msg_rc(*[meta] * 14, 5.0, 8)
    with pytest.raises(ValueError, match="no edge-core implementation"):
        TK.edge_bwd_upd_rc(*[meta] * 7)
    with pytest.raises(ValueError, match="no cap-gradient implementation"):
        TC.amber_grad_rows(tpot.rt.ht.caps, torch.empty((10, 40, 3), device="meta"))
    with pytest.raises(ValueError, match="no fused-layer implementation"):
        TFL.vislayer_fwd(meta, meta, meta, meta, meta, meta, [meta] * 17, 5.0, 8, False)
    with pytest.raises(ValueError, match="no fused-layer implementation"):
        TFL.vislayer_bwd(meta, meta, meta, meta, meta, meta, [meta] * 17, meta, meta, meta,
                         meta, 5.0, 8, False)
