"""The port's graphed Langevin step (ai2bmd_torch.md.graphed) and its bench
script (bench_torch.py), on the CPU: the captured body run eagerly leaves
what langevin_step returns, the noise drawn outside the graph is the noise
langevin_step draws, and neither the graph nor the bench runs without the
card.  Small ViSNet (3 layers x 32) on Chignolin, float32."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from ai2bmd_torch.host import example_pdb, load_protein
from ai2bmd_torch.md import GraphedLangevin, StepBuffers, draw_step_noise, step_into
from ai2bmd_torch.md import langevin as L
from ai2bmd_torch.models.params import init_params
from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
from ai2bmd_torch.potentials import FragmentPotential

SMALL = dict(hidden_channels=32, num_heads=4, num_layers=3, num_rbf=8, max_z=20)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chig():
    prot = load_protein(example_pdb("chig"))
    cfg = ViSNetConfig(**SMALL)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    pot = FragmentPotential.build(prot, ViSNet(cfg, params), cfg, device="cpu")
    P = torch.as_tensor(prot.positions, dtype=torch.float32)
    e0, f0, aux = pot.stateful_energy_forces(P, pot.init_cap_delta(P))
    v0 = L.maxwell_boltzmann_velocities(torch.Generator().manual_seed(1), prot.masses, 300.0)
    coeffs = L.LangevinCoeffs.build(prot.masses, 1.0, 300.0, 0.001, device="cpu")
    masses = torch.as_tensor(prot.masses, dtype=torch.float32)
    return pot, coeffs, masses, L.MDState(P, v0, f0, e0, aux=aux)


def _harmonic(x, aux):
    """A potential cheap enough to run many steps: springs to the origin."""
    return 0.5 * (x * x).sum(), -x, aux


@pytest.mark.parametrize("n_steps", [1, 4])
def test_drawn_noise_is_the_noise_langevin_step_draws(chig, n_steps):
    """n steps fed draw_step_noise's xi/eta from one generator equal n steps
    that draw from an equal generator themselves, bitwise, and leave the two
    generators in the same state (so xi and eta come in the same order and
    shapes: they enter the step with other coefficients)."""
    _, coeffs, masses, s0 = chig
    s0 = L.MDState(s0.positions, s0.velocities, -s0.positions, s0.energy)
    g_draw, g_step = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    buf = StepBuffers.from_state(s0)
    fed, drawn = s0, s0
    for _ in range(n_steps):
        draw_step_noise(g_draw, buf)
        fed = L.langevin_step(_harmonic, coeffs, masses, fed, xi=buf.xi, eta=buf.eta)
        drawn = L.langevin_step(_harmonic, coeffs, masses, drawn, generator=g_step)
    assert torch.equal(fed.positions, drawn.positions)
    assert torch.equal(fed.velocities, drawn.velocities)
    assert torch.equal(g_draw.get_state(), g_step.get_state())
    assert not torch.equal(fed.positions, s0.positions)


def test_captured_body_run_eagerly_matches_langevin_step(chig):
    """The captured body (step_into), run eagerly on the CPU for 3 steps of
    the Chignolin fragment potential, leaves in its buffers exactly what 3
    langevin_step calls return on the same noise, cap offsets included."""
    pot, coeffs, masses, s0 = chig
    before = s0.positions.clone()
    g = torch.Generator().manual_seed(3)
    buf = StepBuffers.from_state(s0)
    ref = s0
    for _ in range(3):
        draw_step_noise(g, buf)
        ref = L.langevin_step(pot.stateful_energy_forces, coeffs, masses, ref, xi=buf.xi,
                              eta=buf.eta)
        step_into(buf, pot.stateful_energy_forces, coeffs, masses)
    got = buf.state(step=3)
    for name in ("positions", "velocities", "forces", "energy", "aux"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert torch.isfinite(got.forces).all() and not torch.equal(got.positions, s0.positions)
    # the buffers are copies: the caller's state is untouched
    assert torch.equal(s0.positions, before)


def test_graphed_langevin_raises_on_cpu_tensors(chig):
    """No eager stand-in for the graph: CPU tensors are refused."""
    pot, coeffs, masses, s0 = chig
    with pytest.raises(RuntimeError, match="CUDA graphs need the card"):
        GraphedLangevin(pot.stateful_energy_forces, coeffs, masses, s0, torch.Generator())


def test_bench_and_graphed_step_load_no_jax():
    """bench_torch.py and md/graphed.py import neither JAX nor ai2bmd_tpu,
    and the bench raises without a card instead of timing the CPU."""
    code = textwrap.dedent("""
        import sys
        import bench_torch
        import ai2bmd_torch.md.graphed
        assert not any(m == "jax" or m.startswith(("jax.", "jaxlib")) for m in sys.modules)
        assert not any(m.startswith("ai2bmd_tpu") for m in sys.modules)
        import torch
        torch.cuda.is_available = lambda: False
        try:
            bench_torch.main()
        except RuntimeError as e:
            print("raised:", e)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "raised: no CUDA device" in out.stdout
