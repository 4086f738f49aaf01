"""PyTorch + CUDA port of ai2bmd_tpu for one NVIDIA H100.

Mirrors the subpackage layout of ``ai2bmd_tpu`` so that each port file maps
to one reference file.  Plain tensor code is PyTorch; every Pallas kernel on
the ported path is a hand-written CUDA kernel under ``ops/csrc/`` with a
plain PyTorch version beside it.  Nothing here imports JAX, and nothing
decides a device at import time: the device comes from the tensors and
modules a caller passes.
"""
