"""Integrators: Langevin steps (``langevin``) and their replay as one CUDA
graph (``graphed``)."""

from ai2bmd_torch.md.graphed import GraphedLangevin, StepBuffers, draw_step_noise, step_into

__all__ = ["GraphedLangevin", "StepBuffers", "draw_step_noise", "step_into"]
