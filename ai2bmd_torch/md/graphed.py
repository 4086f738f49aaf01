"""Steps replayed as one CUDA graph.

Port of ``Simulator._chunk`` (``ai2bmd_tpu/md/simulation.py:110-123``), the
JAX package's MD loop compiled into one device program.  Here one
``langevin_step`` is captured with ``torch.cuda.graph`` and replayed once a
step, so the host issues one graph launch a step instead of every kernel of
the force evaluation.

What the graph holds and what it does not:
- captured: one ``langevin_step`` (both half-kicks, the warm cap L-BFGS, the
  ViSNet calls with their autograd backward, the stitch and the long range;
  on a solvated run also the cell assignment, the MM and PME terms and the
  SETTLE projection), reading and writing static buffers (``StepBuffers``).
  The eager warm-up steps create what a capture cannot, such as cuFFT's
  plans for the PME mesh;
- outside it: the noise.  Before every replay xi, then eta, are drawn from
  the caller's generator into the static noise buffers (``draw_step_noise``),
  with the shapes and order ``langevin_step`` draws them, so a graphed run
  takes the same noise as an eager run with the same generator;
- outside it: the step counter (``MDState.step``, a host int) and the cold
  start (``initial_cap_delta``), which runs eagerly before the capture;
- between runs, ``load`` copies another state into the static buffers
  (a restart, or the start of a pre-equilibration stage), so one capture
  serves a whole simulation; ``replays`` counts the replays.

``GraphedStep`` is the same mechanism for any step that reads and rewrites a
tree of static tensors (the preprocessing stages, ``preprocess.py``; the
AMOEBA descent cycle, ``physics/amoeba_md.py``); ``stepper`` picks it on the
card and the eager call on the CPU.

The graph needs the card: on CPU tensors ``GraphedLangevin`` and
``GraphedStep`` raise, and a failed capture raises too; neither falls back
to eager steps.  The force
stitch and the PME charge spreading sum with atomics (``frag/runtime.py``,
``physics/pme.py``), so a replayed step equals an eager step within float32
rounding, not bitwise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ai2bmd_torch.md.langevin import LangevinCoeffs, MDState, langevin_step
from ai2bmd_torch.utils.tree import tree_clone, tree_copy_, tree_leaves

WARMUP_STEPS = 3


@dataclasses.dataclass
class StepBuffers:
    """The static tensors one captured step reads and overwrites: the MD
    state (positions, velocities, forces, energy, the carry ``aux``: cap
    offsets, or a tuple of tensors) and the step's noise ``xi`` and
    ``eta``."""

    positions: torch.Tensor
    velocities: torch.Tensor
    forces: torch.Tensor
    energy: torch.Tensor
    aux: Any
    xi: torch.Tensor
    eta: torch.Tensor

    @classmethod
    def from_state(cls, state: MDState) -> "StepBuffers":
        """Copies of ``state``'s tensors, and noise buffers of its shape."""
        P = state.positions
        return cls(P.clone(), state.velocities.clone(), state.forces.clone(),
                   state.energy.clone(), tree_clone(state.aux), torch.empty_like(P),
                   torch.empty_like(P))

    def state(self, step: int = 0) -> MDState:
        """An ``MDState`` whose tensors are these buffers (not copies)."""
        return MDState(self.positions, self.velocities, self.forces, self.energy, step=step,
                       aux=self.aux)

    def copy_from(self, state: MDState) -> None:
        """Copy ``state``'s tensors into these buffers, in place."""
        self.positions.copy_(state.positions)
        self.velocities.copy_(state.velocities)
        self.forces.copy_(state.forces)
        self.energy.copy_(state.energy)
        tree_copy_(self.aux, state.aux)


def draw_step_noise(generator: torch.Generator, buf: StepBuffers) -> None:
    """Draw one step's standard normals into ``buf.xi``, then ``buf.eta``,
    as ``langevin_step(generator=...)`` draws them (``md/langevin.py``)."""
    for out in (buf.xi, buf.eta):
        torch.randn(out.shape, generator=generator, out=out)


def step_into(buf: StepBuffers, potential: Callable, coeffs: LangevinCoeffs,
              masses: torch.Tensor, constraint=None) -> None:
    """The captured body: one ``langevin_step`` (with ``constraint``, e.g.
    SETTLE) on the buffers' state and noise, its results copied back into
    the buffers."""
    buf.copy_from(langevin_step(potential, coeffs, masses, buf.state(), xi=buf.xi,
                                eta=buf.eta, constraint=constraint))


class GraphedLangevin:
    """Langevin steps of ``potential`` (the stateful protocol of
    ``langevin_step``) as replays of one captured CUDA graph.

    ``state`` and ``generator`` are the caller's; neither is touched by the
    construction: the warm-up steps run on a copy of the state, with noise
    from a generator of their own.  ``run(n)`` then draws each step's noise
    from ``generator`` and replays the graph; ``state`` aliases the buffers
    the graph overwrites; ``load`` puts another state there.  ``replays``
    counts the graph's replays.  ``setup_seconds`` holds the wall time of
    the warm-up and of the capture (instantiation included)."""

    def __init__(self, potential: Callable, coeffs: LangevinCoeffs, masses: torch.Tensor,
                 state: MDState, generator: torch.Generator, constraint=None):
        if not state.positions.is_cuda:
            raise RuntimeError(f"CUDA graphs need the card: the state is on "
                               f"{state.positions.device}")
        self.generator = generator
        self.step_count = state.step
        self.replays = 0
        self.buffers = StepBuffers.from_state(state)
        body = lambda buf: step_into(buf, potential, coeffs, masses, constraint)

        # eager warm-up on a side stream, as torch.cuda.graphs recommends: it
        # builds the kernels' library, binds their entry points and fills the
        # caches (vislayer._constants) that a capture must find ready
        t0 = time.perf_counter()
        scratch = StepBuffers.from_state(state)
        throwaway = torch.Generator(device=state.positions.device).manual_seed(0)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                draw_step_noise(throwaway, scratch)
                body(scratch)
        torch.cuda.current_stream().wait_stream(side)
        del scratch
        torch.cuda.synchronize()
        t1 = time.perf_counter()

        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            body(self.buffers)
        torch.cuda.synchronize()
        self.setup_seconds = dict(warmup=t1 - t0, capture=time.perf_counter() - t1)

    @property
    def state(self) -> MDState:
        return self.buffers.state(self.step_count)

    def load(self, state: MDState, generator: torch.Generator | None = None) -> None:
        """Continue from ``state``: its tensors are copied into the buffers the
        graph reads, and its step becomes the step counter; ``generator``,
        when given, draws the noise from then on (a replica's own)."""
        self.buffers.copy_from(state)
        self.step_count = state.step
        if generator is not None:
            self.generator = generator

    def run(self, n_steps: int) -> MDState:
        """``n_steps`` steps: per step, the noise draw, then one replay."""
        for _ in range(n_steps):
            draw_step_noise(self.generator, self.buffers)
            self.graph.replay()
            self.step_count += 1
            self.replays += 1
        return self.state


class GraphedStep:
    """``fn(buffers)`` captured once as a CUDA graph: ``fn`` reads the tensors
    of ``buffers`` (a tuple or list of tensors, nested or not) and writes its
    results back into them in place; ``replay()`` runs it again on whatever
    they hold then.  The warm-up calls run on a copy of the buffers, so the
    construction leaves ``buffers`` as it found them."""

    def __init__(self, fn: Callable, buffers, warmup: int = WARMUP_STEPS):
        leaf = tree_leaves(buffers)[0]
        if not leaf.is_cuda:
            raise RuntimeError(f"CUDA graphs need the card: the buffers are on {leaf.device}")
        scratch = tree_clone(buffers)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn(scratch)
        torch.cuda.current_stream().wait_stream(side)
        del scratch
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            fn(buffers)
        torch.cuda.synchronize()
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1


def stepper(fn: Callable, buffers) -> Callable[[], None]:
    """A call of ``fn(buffers)``: on the card a replay of its captured graph
    (``GraphedStep``), on the CPU ``fn`` itself, eagerly."""
    if tree_leaves(buffers)[0].is_cuda:
        return GraphedStep(fn, buffers).replay
    return lambda: fn(buffers)
